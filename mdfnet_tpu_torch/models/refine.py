"""Depth refinement heads: 1/2-res depth -> full res (port of
``mdfnet_tpu/models/refine.py``): RefineNet2 by PixelShuffle (reference
net/unit/refine.py:8-46), and the image-guided RefineNet v1 (reference
refine.py:49-95), the alternative that ``refine_impl="refine1"`` selects.

The depth is normalised to [0, 1] by the scene range; the half-res stack
(conv0, 3 Res blocks, conv1 + skip, conv2_0) is ONE conv chain (K5) with the
Res blocks' 0.1 scale and the skip adds in the epilogue, as in the TPU path
(``refine.py:111-145``); PixelShuffle(2) follows, then the C->1 conv (K4 at
Co = 1, on the co1 kernel, f32 out) and the de-normalisation.

Under spatial sharding the chain runs band-wise as the backbone's do
(``backbone.banded_chain``: its 9 rows of receptive halo a side exchanged
once), PixelShuffle is row-local and the tail conv goes through
``layers.ConvND``'s hook (JAX ``refine.py:55-57``). RefineNet v1 is
refused there: its align-corners upsample depends on the global height
(``parallel/spatial.py``).

Train (JAX ``refine.py:174-210``) runs one differentiable conv per layer
(``conv2d_train``): conv0, the Res blocks ``v + 0.1 * conv(relu(conv(v)))``,
conv1 plus the skip, conv2_0, PixelShuffle, then the C->1 conv. The input
depth is detached, as in the reference, so no gradient flows back through
it into the cascade.
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.backbone import banded_chain
from mdfnet_tpu_torch.models.layers import (ConvBNReLU, ConvND, Res,
                                            TrConvBNReLU2D, pixel_shuffle_2x)
from mdfnet_tpu_torch.ops.cuda.conv_vjp import conv2d_train
from mdfnet_tpu_torch.ops.sample import resize_bilinear_2x_align_corners
from mdfnet_tpu_torch.parallel import halo


def _normalised(depth, depth_range, dtype):
    """(depth (B, h, w) detached, in [0, 1] by each item's range, as (B, h,
    w, 1) in ``dtype``; dmin, dmax as (B, 1, 1) f32)."""
    b = depth.shape[0]
    dmin = depth_range[:, 0].float().reshape(b, 1, 1)
    dmax = depth_range[:, 1].float().reshape(b, 1, 1)
    x = (depth.detach().float() - dmin) / (dmax - dmin)
    return x, x[..., None].to(dtype), dmin, dmax


class RefineNet2(nn.Module):
    """Keys ``conv0``, ``ress.{i}.conv.{0,2}``, ``conv1``, ``conv2.{0,2}``."""

    def __init__(self, base_chs: int = 8, nres: int = 3):
        super().__init__()
        c = base_chs
        self.conv0 = ConvND(1, c, 3)
        self.ress = nn.ModuleList(Res(c) for _ in range(nres))
        self.conv1 = ConvND(c, c, 3)
        self.conv2 = nn.Sequential(ConvND(c, 4 * c, 3), nn.PixelShuffle(2),
                                   ConvND(c, 1, 3))

    def forward(self, depth: torch.Tensor, depth_range: torch.Tensor,
                dtype=torch.float32, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        """depth (B, H/2, W/2) f32, depth_range (B, 2) -> (B, H, W) f32.
        ``dtype``: compute dtype of the convs."""
        _, x, dmin, dmax = _normalised(depth, depth_range, dtype)
        if train:
            out = self._train_convs(x, plain)
            return dmin + out * (dmax - dmin)

        ((layers, relus, resid, _),) = self.eval_chains()
        # the Res blocks' 0.1 scale in the epilogue of their second conv
        second = {2 * i + 2 for i in range(len(self.ress))}
        scales = [torch.full((m.weight.shape[0],), 0.1 if i in second
                             else 1.0, device=depth.device)
                  for i, m in enumerate(layers)]
        offsets = [torch.zeros_like(s) for s in scales]
        x = banded_chain(x, [m.weight.to(dtype) for m in layers], scales,
                         offsets, relu_flags=relus, residuals=resid,
                         plain=plain)
        x = pixel_shuffle_2x(x).contiguous()
        out = self.conv2[2](x, out_dtype=torch.float32, plain=plain)[..., 0]
        return dmin + out * (dmax - dmin)

    def eval_chains(self) -> list:
        """The eval forward's one chain (K5): (ConvND layers, ReLU flags,
        residuals, final stride): conv0, each Res block's two convs (the
        second adds the block's input), conv1 plus the skip of conv0's
        output, conv2's first conv."""
        layers, relus, resid = [self.conv0], [False], [None]
        for i, res in enumerate(self.ress):
            layers += [res.conv[0], res.conv[2]]
            relus += [True, False]
            resid += [None, 2 * i]              # Res adds its own input
        layers += [self.conv1, self.conv2[0]]
        relus += [False, False]
        resid += [0, None]                      # conv1 + skip (conv0's output)
        return [(layers, tuple(relus), tuple(resid), 1)]

    def _train_convs(self, x, plain):
        def conv(m, v):
            return conv2d_train(v, m.weight.to(v.dtype), plain=plain)

        v = skip = conv(self.conv0, x)
        for res in self.ress:
            v = v + 0.1 * conv(res.conv[2], torch.relu(conv(res.conv[0], v)))
        v = skip + conv(self.conv1, v)
        v = pixel_shuffle_2x(conv(self.conv2[0], v))
        return conv(self.conv2[2], v)[..., 0].float()


class RefineNet(nn.Module):
    """RefineNet v1 (JAX ``refine.py:213-260``): the normalised half-res
    depth through conv_depth0, conv_depth1 and the 2x transposed conv
    conv_depth2, the full-res reference image through conv_img; their
    concatenation through conv_res0 and the C -> 1 conv_res1 gives a
    residual on the align-corners 2x upsample of the normalised depth.

    Keys (the port's own: the reference's names for this unused unit are
    not in the JAX package's ``.pth`` map): ``conv_img``, ``conv_depth0``,
    ``conv_depth1``, ``conv_res0`` (ConvBNReLU: ``conv.weight``, ``bn.*``),
    ``conv_depth2`` (``conv.weight`` (I, O, 3, 3), ``bn.*``),
    ``conv_res1.weight``. Its convs run on K4 in eval (the 2D transposed
    conv as a stride-1 conv on the zero-interleaved input) and on
    ``conv2d_train`` (K8) in training."""

    def __init__(self, base_chs: int = 8):
        super().__init__()
        c = base_chs
        self.conv_img = ConvBNReLU(3, c, 3)
        self.conv_depth0 = ConvBNReLU(1, c, 3)
        self.conv_depth1 = ConvBNReLU(c, c, 3)
        self.conv_depth2 = TrConvBNReLU2D(c, c)
        self.conv_res0 = ConvBNReLU(2 * c, c, 3)
        self.conv_res1 = ConvND(c, 1, 3)

    def forward(self, ref_img: torch.Tensor, depth: torch.Tensor,
                depth_range: torch.Tensor, dtype=torch.float32,
                plain: bool = False, train: bool = False) -> torch.Tensor:
        """ref_img (B, H, W, 3), depth (B, H/2, W/2) f32, depth_range (B, 2)
        -> (B, H, W) f32. ``dtype``: compute dtype of the convs."""
        if halo.current_ctx() is not None:
            raise ValueError("spatial sharding is not exact for RefineNet v1 "
                             "(refine_impl='refine1'): its align-corners "
                             "upsample depends on the global height")
        x, xin, dmin, dmax = _normalised(depth, depth_range, dtype)
        kw = dict(plain=plain, train=train)
        img = self.conv_img(ref_img.to(dtype), **kw)
        d = self.conv_depth1(self.conv_depth0(xin, **kw), **kw)
        d = self.conv_depth2(d, **kw)
        res = self.conv_res0(torch.cat([img, d], dim=-1), **kw)
        if train:
            res = self.conv_res1.train_forward(res, plain=plain)[..., 0]
        else:
            res = self.conv_res1(res, out_dtype=torch.float32,
                                 plain=plain)[..., 0]
        out = resize_bilinear_2x_align_corners(x) + res.float()
        return dmin + out * (dmax - dmin)

    def eval_chains(self) -> list:
        """No conv chain (K5): every conv is its own launch."""
        return []
