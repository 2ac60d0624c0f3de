"""Adjoint of the bilinear sample: the gradient splat, plain PyTorch (port of
``mdfnet_tpu/ops/splat.py``).

Every sample's cotangent lands on the (up to) four source pixels under its
bilinear taps, with the taps and weights of the gather of ``ops/sample.py``.
Unlike the JAX version (``dense_splat_2d``: banded tent matmuls under a
row-band and x-window contract), this is a plain scatter-add: exact for any
camera. It is the plain version of the splat kernel
(``ops/cuda/splat_kernel.py``, K7).
"""
from __future__ import annotations

import torch


def splat_2d_plain(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   height: int, width: int) -> torch.Tensor:
    """Splat sample cotangents back onto the source grid.

    Args:
        g: (B, ..., C) cotangents of the samples.
        x, y: (B, ...) the samples' pixel coordinates.
        height, width: the source image's extent.
    Returns:
        (B, height, width, C) float32.
    """
    b, c = g.shape[0], g.shape[-1]
    gf = g.float().reshape(b, -1, c)
    x = x.float().reshape(b, -1)
    y = y.float().reshape(b, -1)
    # the gather's tap rounding (ops/sample.py)
    x = torch.where((x <= -1.0) | (x >= width), torch.full_like(x, -1.0), x)
    y = torch.where((y <= -1.0) | (y >= height), torch.full_like(y, -1.0), y)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    item = torch.arange(b, device=g.device)[:, None]
    out = torch.zeros(b * height * width, c, dtype=torch.float32,
                      device=g.device)
    for dy, ky in ((0, 1.0 - wy), (1, wy)):
        gy = gf * ky[..., None]
        for dx, kx in ((0, 1.0 - wx), (1, wx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
            target = (item * height + yi.clamp(0, height - 1)) * width \
                + xi.clamp(0, width - 1)
            contrib = gy * (kx * inside)[..., None]
            out.index_add_(0, target.reshape(-1), contrib.reshape(-1, c))
    return out.reshape(b, height, width, c)
