"""FPN feature extractor over 4 scales (port of
``mdfnet_tpu/models/backbone.py``, reference net/unit/backbone.py:9-66).

Strided 5x5 stages down to 1/2, 1/4, 1/8, then a top-down path of 2x
bilinear upsamples + 1x1 lateral adds, emitting (y4: 1/8 x c3, y3: 1/4 x c2,
y2: 1/2 x c1), coarsest first. Channels-last (N, H, W, C).

The trunk's same-scale runs go through the conv chain (K5): the full-res
pair plus the first stride-2 conv is one chain, as in the TPU trunk
(``backbone.py:208-219``); the other stride-2 convs run on the 2D conv
kernel (K4).

Eval runs the top-down path linearised, as the JAX eval path does
(``backbone.py:242-316``): the upsample and the 1x1 convs commute, so the
out-convs apply first, at the coarsest scale, and each lateral is composed
with the out-convs after it into one 1x1 conv (its bias folded into the
offsets, in f32, the composed weights rounded to the compute dtype once):

    y4 = out4 x4
    y3 = up2(out3 x4) + (out3 lat3) x3
    y2 = up2(up2(out2 x4) + (out2 lat3) x3) + (out2 lat2) x2

That is three K4 launches, the convs that share an input in one launch with
their output channels concatenated (x4 by [out4 | out3 | out2], x3 by
[out3 lat3 | out2 lat3], x2 by out2 lat2), each upsampled addend in the next
launch's epilogue as its residual; only c2 + c1 channels are upsampled to
1/4 and c1 to 1/2. With ``emit_diffs`` (JAX ``core.py:108-114``: the vector
aggregate with C == 2G at every stage) the out-convs' even and odd output
channels are differenced before composing, so the backbone emits the
G-channel pair differences that the aggregate consumes (exact: the convs
are linear).

Under spatial sharding (``parallel/halo.py``) each chain runs on the chain
kernel band-wise: the band is extended once by the chain's whole receptive
halo (each layer's padding, the last one's stride counted:
``halo.chain_halo``, 4 rows above and 3 below for the trunk, 2 a side for
a same-scale pair), ``conv2d_chain`` runs unchanged on the extended band,
and the band's output rows are kept; the rows a layer's zero padding
corrupts move inward one padding a layer and never reach them. (JAX's
backbone falls to its per-layer XLA path there, ``backbone.py:65-70``.)
The other convs go through ``layers.ConvBNReLU``'s hook; the top-down
path's convs are 1x1 (row-local) and its upsampled addends go through
``ops/sample.py``'s hook; the pair differences are pointwise.

Train (JAX ``backbone.py:80-126``) runs every conv, the 1x1 laterals and
outputs included, as a differentiable conv (``conv2d_train``, K4 forward and
stride-1 input gradient) on a view-major stack of the views, with per-view
BatchNorm statistics (``vgroups``).
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import ConvBNReLU, ConvND
from mdfnet_tpu_torch.ops.cuda import f32_matmul
from mdfnet_tpu_torch.ops.cuda.conv_kernel import conv2d_bn_act, conv2d_chain
from mdfnet_tpu_torch.ops.sample import upsample_2x_nhwc
from mdfnet_tpu_torch.parallel import halo


def banded_chain(x: torch.Tensor, weights, scales, offsets, *,
                 final_stride: int = 1, plain: bool = False,
                 **kw) -> torch.Tensor:
    """``conv2d_chain`` of (N, H, W, C) ``x``; band-wise under spatial
    sharding, with the chain's receptive halo exchanged once."""
    lo, hi = halo.chain_halo([w.shape[-1] for w in weights], final_stride)
    return halo.banded(
        lambda v, _: conv2d_chain(v, weights, scales, offsets,
                                  final_stride=final_stride, plain=plain,
                                  **kw),
        x, h_axis=1, lo=lo, hi=hi, stride=final_stride)


def _chain(x: torch.Tensor, layers, *, final_stride: int = 1,
           plain: bool = False) -> torch.Tensor:
    weights, scales, offsets = zip(*(m.folded(x.dtype) for m in layers))
    return banded_chain(x, weights, scales, offsets,
                        final_stride=final_stride, plain=plain)


class FPN4Scales(nn.Module):
    """``emit_diffs``: the eval forward returns the G = C/2-channel pair
    differences (even minus odd channels) of each output instead of the
    C-channel features; training always returns the features."""

    def __init__(self, chs=(8, 16, 32, 64), emit_diffs: bool = False):
        super().__init__()
        self.emit_diffs = emit_diffs
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
        self._composed = None    # (key, top_down_weights' result)

    def forward(self, x: torch.Tensor, plain: bool = False,
                train: bool = False, vgroups: int = 1):
        """x (N, H, W, 3) in the compute dtype -> (y4, y3, y2). ``train``: x
        stacks ``vgroups`` views view-major, each with its own BatchNorm
        statistics."""
        if train:
            return self._train_forward(x, plain, vgroups)
        trunk, c12, c23, c34 = self.eval_chains()
        v = _chain(x, trunk[0], final_stride=2, plain=plain)
        x2 = _chain(v, c12[0], plain=plain)
        v = self.conv23[0](x2, plain=plain)
        x3 = _chain(v, c23[0], plain=plain)
        v = self.conv34[0](x3, plain=plain)
        x4 = _chain(v, c34[0], plain=plain)

        return self._top_down(x2, x3, x4, plain)

    def top_down_weights(self, dtype) -> list[tuple[torch.Tensor, ...]]:
        """The eval top-down path's three 1x1 convs as (weight (Co, Ci, 1,
        1) in ``dtype``, scale (Co,) of ones, offset (Co,) f32), for x4, x3
        and x2 in turn: [out4 | out3 | out2], [out3 lat3 | out2 lat3] with
        the offsets lat3's bias gives, out2 lat2 with lat2's. Composed in
        f32 once per set of weights: the result is kept until a parameter
        changes (its version or storage: an in-place write through
        ``.data`` is not seen), ``dtype`` or ``emit_diffs``."""
        params = (self.out4.weight, self.out3.weight, self.out2.weight,
                  self.lat3.weight, self.lat2.weight, self.lat3.bias,
                  self.lat2.bias)
        key = (dtype, self.emit_diffs, params[0].device) + tuple(
            (p.data_ptr(), p._version) for p in params)
        if self._composed is None or self._composed[0] != key:
            with torch.no_grad(), f32_matmul():
                self._composed = (key, self._compose(dtype))
        return self._composed[1]

    def _compose(self, dtype):
        def out(m):      # (Co, c3): with emit_diffs, even minus odd rows
            w = m.weight[:, :, 0, 0].float()
            return w[0::2] - w[1::2] if self.emit_diffs else w
        k4, k3, k2 = out(self.out4), out(self.out3), out(self.out2)
        l3, l2 = (m.weight[:, :, 0, 0].float() for m in (self.lat3,
                                                         self.lat2))
        b3, b2 = self.lat3.bias.float(), self.lat2.bias.float()
        w4 = torch.cat([k4, k3, k2])
        convs = [(w4, torch.zeros_like(w4[:, 0])),
                 (torch.cat([k3 @ l3, k2 @ l3]), torch.cat([k3 @ b3,
                                                           k2 @ b3])),
                 (k2 @ l2, k2 @ b2)]
        return [(w.to(dtype)[..., None, None], torch.ones_like(o), o)
                for w, o in convs]

    def _top_down(self, x2, x3, x4, plain):
        """The linearised top-down path: three 1x1 launches (K4)."""
        (w4, s4, o4), (w3, s3, o3), (w2, s2, o2) = \
            self.top_down_weights(x4.dtype)
        n4, n3 = w4.shape[0] - w3.shape[0], w3.shape[0] - w2.shape[0]

        def conv(x, w, scale, offset, residual=None):
            return conv2d_bn_act(x, w, scale, offset, relu=False,
                                 residual=residual, plain=plain)
        v4 = conv(x4, w4, s4, o4)                   # y4 | t3 | u2
        v3 = conv(x3, w3, s3, o3, upsample_2x_nhwc(v4[..., n4:]))  # y3 | s2
        y2 = conv(x2, w2, s2, o2, upsample_2x_nhwc(v3[..., n3:]))
        return v4[..., :n4], v3[..., :n3], y2

    def eval_chains(self) -> list:
        """The eval forward's chains (K5), in order: (ConvBNReLU layers,
        ReLU flags, residuals, final stride) each: the full-res pair with
        the first stride-2 conv, then each scale's same-scale pair."""
        def plain_chain(layers, final_stride=1):
            return (list(layers), (True,) * len(layers),
                    (None,) * len(layers), final_stride)
        return [plain_chain([self.conv01[0], self.conv01[1], self.conv12[0]],
                            2),
                plain_chain(self.conv12[1:]), plain_chain(self.conv23[1:]),
                plain_chain(self.conv34[1:])]

    def _train_forward(self, x, plain, vgroups):
        def run(block, v):
            for layer in block:
                v = layer(v, plain=plain, train=True, vgroups=vgroups)
            return v

        x2 = run(self.conv12, run(self.conv01, x))
        x3 = run(self.conv23, x2)
        x4 = run(self.conv34, x3)
        y4 = self.out4.train_forward(x4, plain=plain)
        x3 = upsample_2x_nhwc(x4) + self.lat3.train_forward(x3, plain=plain)
        y3 = self.out3.train_forward(x3, plain=plain)
        x2 = upsample_2x_nhwc(x3) + self.lat2.train_forward(x2, plain=plain)
        y2 = self.out2.train_forward(x2, plain=plain)
        return y4, y3, y2
