"""Plane-sweep bilinear sampling (K6): CUDA kernel and its plain PyTorch
version.

Port of ``mdfnet_tpu/ops/pallas/warp_kernel.py:143``
(``pallas_sample_2d_multi``, with ``pallas_sample_2d`` :124): the forward of
the training warp (``ops/warp.py:homography_warp_train``). The kernel
(``csrc/sample_2d.cu``) has no source window, so unlike the TPU kernel it
has no coverage contract: it is exact for any camera. Its interpolation
weights stay f32 (the TPU kernel rounds its x weights to the feature dtype).

A CPU tensor takes :func:`sample_2d_plain`; a CUDA tensor launches the
kernel or raises. ``plain=True`` asks for the plain version explicitly.
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch.ops.cuda import build
from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d

# kernel launches since the last reset (the main-path check reads it)
LAUNCHES = {"sample_2d": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # image -> same-type output


def sample_2d_plain(image: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sample_2d`: the gather of ``ops/sample.py`` in
    f32, rounded once to the image's dtype."""
    return bilinear_sample_2d(image.float(), x, y).to(image.dtype)


def sample_2d(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
              plain: bool = False) -> torch.Tensor:
    """Bilinear samples of S images with zero padding.

    Args:
        image: (S, H, W, C) channels-last, bf16 or f32; C % 8 == 0 on CUDA.
        x, y: (S, ...) f32 pixel coordinates (x along W), e.g. (S, D, H, W)
            for a plane sweep.
    Returns:
        (S, ..., C) in the image's dtype, f32 arithmetic.
    """
    if plain or not image.is_cuda:
        return sample_2d_plain(image, x, y)
    s, h, w, c = image.shape
    if image.dtype not in _DTYPES:
        raise ValueError(f"sample_2d: unsupported dtype {image.dtype}")
    if c % 8:
        raise ValueError(f"sample_2d: C={c} is not a multiple of 8")
    if x.shape != y.shape or x.shape[0] != s or x.dtype != torch.float32 \
            or y.dtype != torch.float32:
        raise ValueError(f"sample_2d: coordinates {tuple(x.shape)} "
                         f"{x.dtype} do not match {s} f32 images")
    n = x[0].numel()
    out = torch.empty(x.shape + (c,), dtype=image.dtype, device=image.device)
    for t, name in ((image, "image"), (x, "x"), (y, "y"), (out, "out")):
        build.check_operand(t, name)
    device, stream = build.launch_context(image)
    lib = build.load_library()
    err = lib.mdf_sample_2d(image.data_ptr(), x.data_ptr(), y.data_ptr(),
                            out.data_ptr(), s, n, h, w, c,
                            _DTYPES[image.dtype], device, stream)
    build.check(err, "sample_2d")
    LAUNCHES["sample_2d"] += 1
    return out
