"""3D U-Net cost-volume regularisers (port of
``mdfnet_tpu/models/regularize.py``, reference net/unit/regular.py:9-133).

Volumes are channels-last (B, D, H, W, G). Stage 0 uses the 3-scale net,
stages 1-2 the 4-scale nets. Every conv runs on the 3D conv kernel (K2), every
upsampling block on the transposed-conv kernel (K3) with its skip add fused
into the epilogue, and the final bias-free 3x3x3 conv to one channel
(ProbConv) on the Co = 1 kernel (``csrc/conv_co1.cu``) with an f32 output. The softmax over D is f32.

Train (JAX ``_dhcw_train_path``, ``regularize.py:225-255`` and :361) runs the
same graph on the differentiable convs of ``ops/cuda/conv_vjp.py`` (K8) with
batch-statistics BatchNorm; each upsampling block's output is cropped on D
to its skip before the add, and ProbConv is one conv to Co = 1 in the
compute dtype, then cast to f32.

Under spatial sharding of the eval forward every conv, transposed conv and
ProbConv runs band-wise through the hooks of ``models/layers.py`` (JAX
``regularize.py:73-99``); the softmax over D is pointwise.
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import (
    BatchNorm, ConvBNReLU, ConvND, ConvTranspose3dWeight, TrConvBNReLU3D,
    trconv_bn_relu)


def _cbr(in_ch: int, out_ch: int, stride: int = 1) -> ConvBNReLU:
    return ConvBNReLU(in_ch, out_ch, 3, stride, ndim=3)


class ProbConv(ConvND):
    """Final 3x3x3 conv to a single channel: (B, D, H, W, C) -> f32
    (B, D, H, W) logits. Key ``weight``."""

    def __init__(self, in_ch: int):
        super().__init__(in_ch, 1, 3, ndim=3)

    def forward(self, x: torch.Tensor, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        if train:
            return self.train_forward(x, plain=plain)[..., 0].float()
        return super().forward(x, out_dtype=torch.float32, plain=plain)[..., 0]


class RegularNet3Scales(nn.Module):
    """Stage-0 regulariser; H and W must divide 4."""

    def __init__(self, in_ch: int, inner_chs: int = 16):
        super().__init__()
        c0, c1, c2 = inner_chs, inner_chs * 2, inner_chs * 4
        self.conv01 = nn.Sequential(_cbr(in_ch, c0), _cbr(c0, c0))
        self.conv12 = nn.Sequential(_cbr(c0, c1, 2), _cbr(c1, c1),
                                    _cbr(c1, c1))
        self.conv232 = nn.Sequential(_cbr(c1, c2, 2), _cbr(c2, c2),
                                     _cbr(c2, c2),
                                     ConvTranspose3dWeight(c2, c1),
                                     BatchNorm(c1), nn.ReLU())
        self.conv10 = TrConvBNReLU3D(c1, c0)
        self.prob = ProbConv(c0)

    def forward(self, x: torch.Tensor, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        """x (B, D, H, W, G) in the compute dtype -> (B, D, H, W) f32 probs."""
        kw = dict(plain=plain, train=train)
        v = self.conv01[0](x, **kw)
        skip0 = self.conv01[1](v, **kw)
        v = self.conv12[0](skip0, **kw)
        v = self.conv12[1](v, **kw)
        skip1 = self.conv12[2](v, **kw)
        v = self.conv232[0](skip1, **kw)
        v = self.conv232[1](v, **kw)
        v = self.conv232[2](v, **kw)
        v = trconv_bn_relu(v, self.conv232[3], self.conv232[4],
                           residual=skip1, **kw)
        v = self.conv10(v, residual=skip0, **kw)
        return torch.softmax(self.prob(v, **kw), dim=1)


class RegularNet4Scales(nn.Module):
    """Stage-1/2 regulariser; H and W must divide 8."""

    def __init__(self, in_ch: int, base_chs: int = 8):
        super().__init__()
        c0, c1, c2, c3 = base_chs, base_chs * 2, base_chs * 4, base_chs * 8
        self.conv01 = _cbr(in_ch, c0)
        self.conv12 = nn.Sequential(_cbr(c0, c1, 2), _cbr(c1, c1))
        self.conv23 = nn.Sequential(_cbr(c1, c2, 2), _cbr(c2, c2))
        self.conv343 = nn.Sequential(_cbr(c2, c3, 2), _cbr(c3, c3),
                                     ConvTranspose3dWeight(c3, c2),
                                     BatchNorm(c2), nn.ReLU())
        self.trconv32 = TrConvBNReLU3D(c2, c1)
        self.trconv21 = TrConvBNReLU3D(c1, c0)
        self.prob = ProbConv(c0)

    def forward(self, x: torch.Tensor, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        """x (B, D, H, W, G) in the compute dtype -> (B, D, H, W) f32 probs."""
        kw = dict(plain=plain, train=train)
        x1 = self.conv01(x, **kw)
        v = self.conv12[0](x1, **kw)
        x2 = self.conv12[1](v, **kw)
        v = self.conv23[0](x2, **kw)
        x3 = self.conv23[1](v, **kw)
        v = self.conv343[0](x3, **kw)
        v = self.conv343[1](v, **kw)
        v = trconv_bn_relu(v, self.conv343[2], self.conv343[3], residual=x3,
                           **kw)
        v = self.trconv32(v, residual=x2, **kw)
        v = self.trconv21(v, residual=x1, **kw)
        return torch.softmax(self.prob(v, **kw), dim=1)
