"""Depth refinement head: 1/2-res depth -> full res via PixelShuffle (port of
``mdfnet_tpu/models/refine.py`` RefineNet2, reference net/unit/refine.py:8-46).

The depth is normalised to [0, 1] by the scene range; the half-res stack
(conv0, 3 Res blocks, conv1 + skip, conv2_0) is ONE conv chain (K5) with the
Res blocks' 0.1 scale and the skip adds in the epilogue, as in the TPU path
(``refine.py:111-145``); PixelShuffle(2) follows, then the C->1 conv (K4 at
Co = 1, on the co1 kernel, f32 out) and the de-normalisation.

Train (JAX ``refine.py:174-210``) runs one differentiable conv per layer
(``conv2d_train``): conv0, the Res blocks ``v + 0.1 * conv(relu(conv(v)))``,
conv1 plus the skip, conv2_0, PixelShuffle, then the C->1 conv. The input
depth is detached, as in the reference, so no gradient flows back through
it into the cascade.
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import ConvND, Res, pixel_shuffle_2x
from mdfnet_tpu_torch.ops.cuda.conv_kernel import conv2d_chain
from mdfnet_tpu_torch.ops.cuda.conv_vjp import conv2d_train


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
        b = depth.shape[0]
        dmin = depth_range[:, 0].float().reshape(b, 1, 1)
        dmax = depth_range[:, 1].float().reshape(b, 1, 1)
        x = ((depth.detach().float() - dmin)
             / (dmax - dmin))[..., None].to(dtype)
        if train:
            out = self._train_convs(x, plain)
            return dmin + out * (dmax - dmin)

        c = self.conv1.weight.shape[0]
        ones = torch.ones(c, device=depth.device)
        layers = [self.conv0]
        scales, relus, resid = [ones], [False], [None]
        for i, res in enumerate(self.ress):
            layers += [res.conv[0], res.conv[2]]
            scales += [ones, ones * 0.1]        # 0.1 Res scale in the epilogue
            relus += [True, False]
            resid += [None, 2 * i]              # Res adds its own input
        layers += [self.conv1, self.conv2[0]]
        scales += [ones, torch.ones(4 * c, device=depth.device)]
        relus += [False, False]
        resid += [0, None]                      # conv1 + skip (conv0's output)
        offsets = [torch.zeros_like(s) for s in scales]
        x = conv2d_chain(x, [m.weight.to(dtype) for m in layers], scales,
                         offsets, relu_flags=tuple(relus),
                         residuals=tuple(resid), plain=plain)
        x = pixel_shuffle_2x(x).contiguous()
        out = self.conv2[2](x, out_dtype=torch.float32, plain=plain)[..., 0]
        return dmin + out * (dmax - dmin)

    def _train_convs(self, x, plain):
        def conv(m, v):
            return conv2d_train(v, m.weight.to(v.dtype), plain=plain)

        v = skip = conv(self.conv0, x)
        for res in self.ress:
            v = v + 0.1 * conv(res.conv[2], torch.relu(conv(res.conv[0], v)))
        v = skip + conv(self.conv1, v)
        v = pixel_shuffle_2x(conv(self.conv2[0], v))
        return conv(self.conv2[2], v)[..., 0].float()
