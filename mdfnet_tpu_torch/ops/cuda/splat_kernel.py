"""The gradient splat, adjoint of the bilinear sample (K7): CUDA kernels and
their plain PyTorch version.

Port of ``mdfnet_tpu/ops/pallas/splat_kernel.py:129`` (``pallas_splat_2d``),
the backward of the training warp (``ops/warp.py:homography_warp_train``).
Exact for any camera and deterministic (``csrc/splat_2d.cu``): one kernel
writes each (sample, tap)'s target pixel, a stable sort orders them, and a
second kernel sums each pixel's run in that order, with no atomics. Two
launches on the same inputs give bit-identical output.

A CPU tensor takes :func:`mdfnet_tpu_torch.ops.splat.splat_2d_plain`; a CUDA
tensor launches the kernels or raises. ``plain=True`` asks for the plain
version explicitly.
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch.ops.cuda import build
from mdfnet_tpu_torch.ops.splat import splat_2d_plain

# kernel launches since the last reset (the main-path check reads it); one
# per call, which launches the key and the reduce kernel
LAUNCHES = {"splat_2d": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 2}   # g -> f32 output codes


def splat_2d(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor, height: int,
             width: int, *, plain: bool = False) -> torch.Tensor:
    """Splat sample cotangents back onto the source grid.

    Args:
        g: (B, P, R, T, C) cotangents of the samples (P depth planes), bf16
            or f32; C % 8 == 0 on CUDA.
        x, y: (B, P, R, T) f32 sample pixel coordinates.
        height, width: the source image's extent.
    Returns:
        (B, height, width, C) float32.
    """
    if plain or not g.is_cuda:
        return splat_2d_plain(g, x, y, height, width)
    b, c = g.shape[0], g.shape[-1]
    if g.dtype not in _DTYPES:
        raise ValueError(f"splat_2d: unsupported dtype {g.dtype}")
    if c % 8:
        raise ValueError(f"splat_2d: C={c} is not a multiple of 8")
    if x.shape != g.shape[:-1] or y.shape != x.shape \
            or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"splat_2d: coordinates {tuple(x.shape)} {x.dtype} "
                         f"do not match g {tuple(g.shape)}")
    n = x[0].numel()
    if 4 * b * n >= 2**31 or b * height * width >= 2**31:
        raise ValueError("splat_2d: more than 2^31 taps or target pixels")
    pixels = b * height * width
    keys = torch.empty(b * n * 4, dtype=torch.int32, device=g.device)
    out = torch.empty((b, height, width, c), dtype=torch.float32,
                      device=g.device)
    for t, name in ((g, "g"), (x, "x"), (y, "y"), (keys, "keys"),
                    (out, "out")):
        build.check_operand(t, name)
    device, stream = build.launch_context(g)
    lib = build.load_library()
    build.check(lib.mdf_splat_keys(x.data_ptr(), y.data_ptr(),
                                   keys.data_ptr(), b, n, height, width,
                                   device, stream), "splat_keys")
    keys, order = torch.sort(keys, stable=True)
    start = torch.searchsorted(keys, torch.arange(
        pixels + 1, dtype=torch.int32, device=g.device))
    for t, name in ((order, "order"), (start, "start")):
        build.check_operand(t, name)
    build.check(lib.mdf_splat_reduce(
        g.data_ptr(), x.data_ptr(), y.data_ptr(), order.data_ptr(),
        start.data_ptr(), out.data_ptr(), b, height, width, c,
        _DTYPES[g.dtype], device, stream), "splat_reduce")
    LAUNCHES["splat_2d"] += 1
    return out
