"""Plane-sweep bilinear sampling (K6): CUDA kernel and its plain PyTorch
version.

Port of ``mdfnet_tpu/ops/pallas/warp_kernel.py:143``
(``pallas_sample_2d_multi``, with ``pallas_sample_2d`` :124): the forward of
the training warp (``ops/warp.py:homography_warp_train``) and the eval warp
of the variance aggregate and of the vector aggregate at C/G != 2. The
kernel (``csrc/sample_2d.cu``) has no source window, so unlike the TPU
kernel it has no coverage contract: it is exact for any camera. Its
interpolation weights stay f32 (the TPU kernel rounds its x weights to the
feature dtype).

The kernel walks units of a tile on a run of planes (:func:`sample_plan`):
where a unit's tap bounding box fits the plan's budget it is staged in
shared memory, else the unit reads its taps from global memory; the two
branches give the same bits. A sample outside the source (x or y snapped to
-1 with a zero weight) reads no tap and writes +0. The plain version still
multiplies the in-source taps of such a sample by their zero weights: with
finite features it gives +0 too, but where a feature in the source's first
row or column is Inf or NaN it gives NaN there, and the kernel gives +0
(the samples inside the source that read that feature give NaN in both). A
CPU tensor takes :func:`sample_2d_plain`; a CUDA tensor
launches the kernel or raises. ``plain=True`` asks for the plain version
explicitly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mdfnet_tpu_torch.ops.cuda import build
from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d
from mdfnet_tpu_torch.utils import tracing

# kernel launches since the last reset (the main-path check reads it)
LAUNCHES = {"sample_2d": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # image -> same-type output

THREADS = 256                 # a block
RUN = 8                       # planes a unit of work at most (csrc kRun)
# planes a unit in f32: a sample moves twice a bf16 one's bytes, and more,
# shorter units ran faster than runs of RUN at every f32 shape that a path
# launches (paired device-time reads on the card, PERF.md); 2 at 64 channels
F32_RUN, F32_RUN_WIDE = 4, 2
# bytes of one staged box: with the samples' table, four blocks' fit an
# SM's 227 KB (its launch bounds hold three)
BOX_BYTES = 52 * 1024
SM_SMEM = 227 * 1024
TILE_WIDTHS = (16, 32, 64)


def stage_route(c: int, d: int, dtype: torch.dtype) -> bool:
    """Whether K6 stages its units' boxes in shared memory (else every
    unit reads its taps from global memory, through L1), for a source of
    ``c`` channels of ``dtype`` sampled on ``d`` planes. Set by paired
    device-time reads of the two at every shape that a path launches
    (``python3 chip_smoke.py --k6``, PERF.md; staged / global): bf16
    at 64 channels 0.90 and 0.91 (DTU eval and C/G = 4 train stage 0), at
    32 channels on 24 planes 0.96 and 1.00 (their stage 1), on 48 planes
    1.00 (dense train stage 0); 1.06-1.17 at 16 and 8 channels and
    1.03-1.14 in f32 (the fused step's backward), where the pass that
    finds a unit's box costs more than its L1 reads save. In f32 at 64
    channels staged runs of 8 planes beat global ones, but global runs of
    F32_RUN_WIDE beat both (PERF.md)."""
    return dtype == torch.bfloat16 and (c >= 64 or (c >= 32 and d <= 24))


class SamplePlan(NamedTuple):
    lanes: int        # lanes a sample: C / 8, to a power of two, at most 8
    rounds: int       # 32-sample rounds of a warp in a tile
    tile_h: int       # a tile's rows ...
    tile_w: int       # ... and columns of one plane
    tiles_h: int      # tiles down ...
    tiles_w: int      # ... and across a plane
    run: int          # planes a unit of work: a tile on a run of planes
    units: int        # S runs tiles_h tiles_w
    budget: int       # elements a staged box may hold (0: never staged)
    smem: int         # dynamic shared memory a block (the box, a table)


def sample_plan(s: int, d: int, h: int, w: int, src_h: int, src_w: int,
                c: int, dtype: torch.dtype, staged: bool | None = None
                ) -> SamplePlan:
    """The launch of K6 over ``s`` images of ``d`` planes of ``h`` x ``w``
    samples, each sampling a ``src_h`` x ``src_w`` x ``c`` source of
    ``dtype``: a tile of at most THREADS x rounds samples (one round of 32
    where a sample is 128 bytes or more, two below), the width of
    TILE_WIDTHS that leaves the fewest idle samples at the plane's edges
    (the wider on a tie: longer runs of coordinates and output); units of
    a tile on a run of up to RUN planes (F32_RUN in f32, F32_RUN_WIDE at 64
    channels or more), whose taps' box is staged once
    where :func:`stage_route` (or ``staged``, where given) says so; a
    budget of BOX_BYTES a box, or of the tile's box at a one-pixel halo
    where that is more (none where the units are not staged: every unit
    reads its taps from global memory). The kernel runs a block a unit.
    Raises where the kernel's 32-bit offsets or packed taps cannot hold the
    shapes."""
    if c <= 0 or c % 8:
        raise ValueError(f"sample_plan: {c} channels")
    if dtype not in _DTYPES:
        raise ValueError(f"sample_plan: unsupported dtype {dtype}")
    if src_h >= 2**15 or src_w >= 2**15:
        raise ValueError(f"sample_2d: a {src_h}x{src_w} source does not fit "
                         f"the packed taps (< 2^15)")
    if src_h * src_w * c >= 2**31 or h * w * c >= 2**31:
        raise ValueError("sample_2d: an image or a plane of 2^31 values or "
                         "more")
    esize = torch.finfo(dtype).bits // 8
    lanes = min(8, 1 << (c // 8 - 1).bit_length())
    rounds = 1 if c * esize >= 128 else 2
    n = THREADS * rounds

    def slots(tw):
        th = n // tw
        return -(-h // th) * -(-w // tw) * th * tw
    tile_w = min(TILE_WIDTHS, key=lambda tw: (slots(tw), -tw))
    tile_h = n // tile_w
    tiles_h, tiles_w = -(-h // tile_h), -(-w // tile_w)
    run = RUN if dtype == torch.bfloat16 else (
        F32_RUN_WIDE if c >= 64 else F32_RUN)
    run = min(run, max(d, 1))
    units = s * -(-d // run) * tiles_h * tiles_w
    budget = 0
    if stage_route(c, d, dtype) if staged is None else staged:
        box = (tile_h + 2) * (tile_w + 2) * c * esize
        budget = min(max(BOX_BYTES, box), SM_SMEM - 9 * 1024)
        budget = budget // 16 * 16 // esize
    if units >= 2**31:
        raise ValueError(f"sample_2d: {units} units of work, 2^31 or more")
    # the box and the table of the samples' taps (16 bytes a sample)
    smem = budget * esize + 16 * THREADS * rounds
    return SamplePlan(lanes, rounds, tile_h, tile_w, tiles_h, tiles_w, run,
                      units, budget, smem)


def sample_grid(shape) -> tuple[int, int, int]:
    """(planes, rows, columns) of an image's sample coordinates of
    ``shape`` (S, ...): (S, D, H, W) or any (S, ..., H, W); (S, N) is one
    row of N."""
    dims = tuple(shape[1:])
    if len(dims) < 2:
        return 1, 1, (dims[0] if dims else 1)
    d = 1
    for v in dims[:-2]:
        d *= v
    return d, dims[-2], dims[-1]


def sample_2d_plain(image: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sample_2d`: the gather of ``ops/sample.py`` in
    f32, rounded once to the image's dtype."""
    return bilinear_sample_2d(image.float(), x, y).to(image.dtype)


def sample_2d(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
              plain: bool = False, counts: torch.Tensor | None = None,
              staged: bool | None = None) -> torch.Tensor:
    """Bilinear samples of S images with zero padding.

    Args:
        image: (S, H, W, C) channels-last, bf16 or f32; C % 8 == 0 on CUDA.
        x, y: (S, ...) f32 pixel coordinates (x along W), e.g. (S, D, H, W)
            for a plane sweep.
        counts: optional int64 CUDA tensor of 2, to which the kernel adds
            its units staged in shared memory and on the global branch.
        staged: True stages every unit that fits, False puts every unit on
            the global branch; None: :func:`stage_route`'s choice.
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
    with tracing.span("kernel/sample_2d"):
        plan = sample_plan(s, *sample_grid(x.shape), h, w, c, image.dtype,
                           staged)
        out = torch.empty(x.shape + (c,), dtype=image.dtype,
                          device=image.device)
        for t, name in ((image, "image"), (x, "x"), (y, "y"), (out, "out")):
            build.check_operand(t, name)
        if counts is not None:
            build.check_operand(counts, "counts")
            if counts.dtype != torch.int64 or counts.numel() != 2:
                raise ValueError("sample_2d: counts must be 2 int64 values")
        device, stream = build.launch_context(image)
        lib = build.load_library()
        err = lib.mdf_sample_2d(
            image.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            0 if counts is None else counts.data_ptr(), s,
            *sample_grid(x.shape), h, w, c, plan.tile_h, plan.tile_w,
            plan.run, plan.lanes, plan.rounds, plan.budget,
            _DTYPES[image.dtype], device, stream)
        build.check(err, "sample_2d")
        LAUNCHES["sample_2d"] += 1
    return out
