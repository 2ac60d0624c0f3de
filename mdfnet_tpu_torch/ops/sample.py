"""Image sampling and 2x resizes (port of ``mdfnet_tpu/ops/sample.py``).

``bilinear_sample_2d`` reproduces torch ``grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=False)`` in pixel space, with the JAX
package's tap rounding: coordinates fully outside the image snap to -1, where
both taps read zeros or carry zero weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mdfnet_tpu_torch.geometry import fma


def bilinear_sample_2d(image: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """Sample ``image`` at float pixel coordinates with zero padding.

    Args:
        image: (B, H, W, C) channels-last.
        x, y: (B, ...) float pixel coordinates (x along W).
        fused: blend the taps with fused multiply-adds where the JAX
            package's CPU backend contracts them (f32 ``image``), which
            gives its bits on any device (the fusion backends' resampling).
    Returns:
        (B, ..., C) samples.
    """
    b, h, w, c = image.shape
    out_shape = x.shape[1:]
    x = x.reshape(b, -1).float()
    y = y.reshape(b, -1).float()
    x = torch.where((x <= -1.0) | (x >= w), torch.full_like(x, -1.0), x)
    y = torch.where((y <= -1.0) | (y >= h), torch.full_like(y, -1.0), y)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None].to(image.dtype)
    wy = (y - y0)[..., None].to(image.dtype)

    # taps index a zero-padded copy: x0 in [-1, w-1] -> column x0 + 1
    hp, wp = h + 2, w + 2
    flat = F.pad(image, (0, 0, 1, 1, 1, 1)).reshape(b * hp * wp, c)
    xi = (x0.long() + 1).clamp(0, w)
    yi = (y0.long() + 1).clamp(0, h)
    base = yi * wp + xi + (torch.arange(b, device=image.device)
                           * (hp * wp))[:, None]
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + wp], flat[base + wp + 1]
    if fused:
        top = fma(v01, wx, v00 * (1 - wx))
        bot = fma(v11, wx, v10 * (1 - wx))
        out = fma(top, 1 - wy, bot * wy)
    else:
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        out = top * (1 - wy) + bot * wy
    return out.reshape((b,) + tuple(out_shape) + (c,))


def _upsample_last(v: torch.Tensor) -> torch.Tensor:
    # output 2k samples at k - 0.25, 2k+1 at k + 0.25 (edge-replicated)
    left = torch.cat([v[..., :1], v[..., :-1]], dim=-1)
    right = torch.cat([v[..., 1:], v[..., -1:]], dim=-1)
    even = 0.75 * v + 0.25 * left
    odd = 0.75 * v + 0.25 * right
    return torch.stack([even, odd], dim=-1).reshape(
        v.shape[:-1] + (2 * v.shape[-1],))


def resize_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (..., H, W), half-pixel centres (torch
    ``align_corners=False``): a fixed 0.25/0.75 stencil, width then height."""
    x = _upsample_last(x)
    return _upsample_last(x.transpose(-1, -2)).transpose(-1, -2)


def resize_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample over the trailing two axes."""
    return x.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
