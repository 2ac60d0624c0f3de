"""Image sampling and 2x resizes (port of ``mdfnet_tpu/ops/sample.py``).

``bilinear_sample_2d`` reproduces torch ``grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=False)`` in pixel space, with the JAX
package's tap rounding: coordinates fully outside the image snap to -1, where
both taps read zeros or carry zero weight.

Under spatial sharding (``parallel/halo.py``) the two half-pixel 2x bilinear
upsamples exchange one row a side with the neighbouring bands, replicated
at the image's edges, upsample, and drop the two extra output rows a side
(JAX ``sample.py:141-150``); the nearest upsample is row-local. The
align-corners upsample depends on the global height and the bicubic one
has no halo: the units that use them are refused under sharding
(``parallel/spatial.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mdfnet_tpu_torch.geometry import fma
from mdfnet_tpu_torch.parallel import halo


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


def _upsample_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
    """2x along ``axis``: output 2k samples k - 0.25, 2k+1 samples k + 0.25
    (edge-replicated). Even and odd outputs are written from shifted slices
    into one (..., n, 2, ...) tensor, with no concatenated copy of v."""
    axis %= v.dim()
    n = v.shape[axis]
    out = v.new_empty(v.shape[:axis] + (n, 2) + v.shape[axis + 1:])
    even, odd = out.select(axis + 1, 0), out.select(axis + 1, 1)
    near, far = 0.75 * v, 0.25 * v

    def sl(t, start, length):
        return t.narrow(axis, start, length)

    def put(dst, a, b):   # dst = a + b (autograd takes no out=)
        if torch.is_grad_enabled() and v.requires_grad:
            dst.copy_(a + b)
        else:
            torch.add(a, b, out=dst)
    # even[k] = near[k] + far[k-1], odd[k] = near[k] + far[k+1]; the edges
    # take their own value as the missing neighbour
    put(sl(even, 1, n - 1), sl(near, 1, n - 1), sl(far, 0, n - 1))
    put(sl(even, 0, 1), sl(near, 0, 1), sl(far, 0, 1))
    put(sl(odd, 0, n - 1), sl(near, 0, n - 1), sl(far, 1, n - 1))
    put(sl(odd, n - 1, 1), sl(near, n - 1, 1), sl(far, n - 1, 1))
    return out.reshape(v.shape[:axis] + (2 * n,) + v.shape[axis + 1:])


def _upsample_rows(v: torch.Tensor, axis: int) -> torch.Tensor:
    """:func:`_upsample_axis` along the H axis ``axis``; band-wise under
    spatial sharding: one true row a side from the neighbouring bands
    (the band's own edge row at the image's edges, as the stencil
    replicates it), the two extra output rows a side dropped."""
    if halo.current_ctx() is None:
        return _upsample_axis(v, axis)
    v = halo.halo_exchange(v, axis, 1, 1, edge="replicate")
    return _upsample_axis(v, axis).narrow(
        axis, 2, 2 * v.shape[axis] - 4).contiguous()


def resize_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (..., H, W), half-pixel centres (torch
    ``align_corners=False``): a fixed 0.25/0.75 stencil, width then height."""
    return _upsample_rows(_upsample_axis(x, -1), x.dim() - 2)


def upsample_2x_nhwc(x: torch.Tensor) -> torch.Tensor:
    """:func:`resize_bilinear_2x` of (N, H, W, C) over H and W, in place of
    its channels-last layout (the same arithmetic, so the same bits)."""
    return _upsample_rows(_upsample_axis(x, 2), 1)


def resize_bilinear_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (..., H, W) with torch ``align_corners=True``
    (RefineNet v1's ``F.interpolate``): output i samples input i (N-1) /
    (2N-1), so the taps' weights vary per output pixel."""
    def upsample(v, axis):
        n = v.shape[axis]
        pos = torch.arange(2 * n, dtype=torch.float32, device=v.device) \
            * ((n - 1) / (2 * n - 1))
        i0 = torch.floor(pos).long()
        i1 = torch.clamp(i0 + 1, max=n - 1)
        f = (pos - i0.float()).to(v.dtype)
        shape = [1] * v.dim()
        shape[axis] = 2 * n
        f = f.reshape(shape)
        return (v.index_select(axis, i0) * (1 - f)
                + v.index_select(axis, i1) * f)

    return upsample(upsample(x, x.dim() - 1), x.dim() - 2)


# torch's cubic kernel (a = -0.75) at the 2x taps' distances 1.75, 0.75,
# 0.25 and 1.25
_CUBIC = (-0.03515625, 0.26171875, 0.87890625, -0.10546875)


def resize_bicubic_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bicubic upsample of (..., H, W) as torch's (``align_corners=
    False``, a = -0.75, borders replicated): output 2k samples input k -
    0.25, 2k+1 samples k + 0.25, width then height."""
    w_far, w_near, w_center, w_over = _CUBIC

    def upsample(v, axis):
        n = v.shape[axis]
        padded = torch.cat([v.narrow(axis, 0, 1).repeat_interleave(2, axis),
                            v, v.narrow(axis, n - 1, 1).repeat_interleave(
                                2, axis)], dim=axis)

        def sh(k):   # v shifted by k along axis, edges replicated
            return padded.narrow(axis, 2 + k, n)
        even = w_far * sh(-2) + w_near * sh(-1) + w_center * v + w_over * sh(1)
        odd = w_over * sh(-1) + w_center * v + w_near * sh(1) + w_far * sh(2)
        return torch.stack([even, odd], dim=axis + 1).reshape(
            v.shape[:axis] + (2 * n,) + v.shape[axis + 1:])

    return upsample(upsample(x, x.dim() - 1), x.dim() - 2)


def resize_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample over the trailing two axes."""
    return x.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
