"""FPN feature extractor over 4 scales (port of
``mdfnet_tpu/models/backbone.py``, reference net/unit/backbone.py:9-66).

Strided 5x5 stages down to 1/2, 1/4, 1/8, then a top-down path of 2x
bilinear upsamples + 1x1 lateral adds, emitting (y4: 1/8 x c3, y3: 1/4 x c2,
y2: 1/2 x c1), coarsest first. Channels-last (N, H, W, C).

The trunk's same-scale runs go through the conv chain (K5): the full-res
pair plus the first stride-2 conv is one chain, as in the TPU trunk
(``backbone.py:208-219``); the other stride-2 convs and the 1x1 convs run on
the 2D conv kernel (K4), with each lateral's upsampled addend fused into its
epilogue as a residual.

Train (JAX ``backbone.py:80-126``) runs every conv, the 1x1 laterals and
outputs included, as a differentiable conv (``conv2d_train``, K4 forward and
stride-1 input gradient) on a view-major stack of the views, with per-view
BatchNorm statistics (``vgroups``).
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import ConvBNReLU, ConvND
from mdfnet_tpu_torch.ops.cuda.conv_kernel import conv2d_chain
from mdfnet_tpu_torch.ops.sample import resize_bilinear_2x


def _chain(x: torch.Tensor, layers, *, final_stride: int = 1,
           plain: bool = False) -> torch.Tensor:
    weights, scales, offsets = zip(*(m.folded(x.dtype) for m in layers))
    return conv2d_chain(x, weights, scales, offsets,
                        final_stride=final_stride, plain=plain)


def _up2(v: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (N, H, W, C)."""
    return resize_bilinear_2x(v.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) \
        .contiguous()


class FPN4Scales(nn.Module):
    def __init__(self, chs=(8, 16, 32, 64)):
        super().__init__()
        c0, c1, c2, c3 = chs
        self.conv01 = nn.Sequential(ConvBNReLU(3, c0, 3),
                                    ConvBNReLU(c0, c0, 3))
        self.conv12 = nn.Sequential(ConvBNReLU(c0, c1, 5, 2),
                                    ConvBNReLU(c1, c1, 3),
                                    ConvBNReLU(c1, c1, 3))
        self.conv23 = nn.Sequential(ConvBNReLU(c1, c2, 5, 2),
                                    ConvBNReLU(c2, c2, 3),
                                    ConvBNReLU(c2, c2, 3))
        self.conv34 = nn.Sequential(ConvBNReLU(c2, c3, 5, 2),
                                    ConvBNReLU(c3, c3, 3),
                                    ConvBNReLU(c3, c3, 3))
        self.lat2 = ConvND(c1, c3, 1, bias=True)
        self.lat3 = ConvND(c2, c3, 1, bias=True)
        self.out2 = ConvND(c3, c1, 1)
        self.out3 = ConvND(c3, c2, 1)
        self.out4 = ConvND(c3, c3, 1)

    def forward(self, x: torch.Tensor, plain: bool = False,
                train: bool = False, vgroups: int = 1):
        """x (N, H, W, 3) in the compute dtype -> (y4, y3, y2). ``train``: x
        stacks ``vgroups`` views view-major, each with its own BatchNorm
        statistics."""
        if train:
            return self._train_forward(x, plain, vgroups)
        v = _chain(x, [self.conv01[0], self.conv01[1], self.conv12[0]],
                   final_stride=2, plain=plain)
        x2 = _chain(v, self.conv12[1:], plain=plain)
        v = self.conv23[0](x2, plain=plain)
        x3 = _chain(v, self.conv23[1:], plain=plain)
        v = self.conv34[0](x3, plain=plain)
        x4 = _chain(v, self.conv34[1:], plain=plain)

        y4 = self.out4(x4, plain=plain)
        x3 = self.lat3(x3, residual=_up2(x4), plain=plain)   # up2(x4) + lat3
        y3 = self.out3(x3, plain=plain)
        x2 = self.lat2(x2, residual=_up2(x3), plain=plain)   # up2(x3) + lat2
        y2 = self.out2(x2, plain=plain)
        return y4, y3, y2

    def _train_forward(self, x, plain, vgroups):
        def run(block, v):
            for layer in block:
                v = layer(v, plain=plain, train=True, vgroups=vgroups)
            return v

        x2 = run(self.conv12, run(self.conv01, x))
        x3 = run(self.conv23, x2)
        x4 = run(self.conv34, x3)
        y4 = self.out4.train_forward(x4, plain=plain)
        x3 = _up2(x4) + self.lat3.train_forward(x3, plain=plain)
        y3 = self.out3.train_forward(x3, plain=plain)
        x2 = _up2(x3) + self.lat2.train_forward(x2, plain=plain)
        y2 = self.out2.train_forward(x2, plain=plain)
        return y4, y3, y2
