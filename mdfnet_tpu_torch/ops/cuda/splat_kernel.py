"""The gradient splat, adjoint of the bilinear sample (K7): CUDA kernels and
their plain PyTorch version.

Port of ``mdfnet_tpu/ops/pallas/splat_kernel.py:129`` (``pallas_splat_2d``),
the backward of the training warp (``ops/warp.py:homography_warp_train``).
Exact for any camera and deterministic, with no sort and no float atomics
(``csrc/splat_2d.cu``): the samples are binned by tile in a stable counting
sort (count, scan, bin), and one block per tile and group of channels sums
each pixel's terms in ascending sample order. Two launches on the same inputs
give bit-identical output, the bits of the sort-based kernel it replaced.

A CPU tensor takes :func:`mdfnet_tpu_torch.ops.splat.splat_2d_plain`; a CUDA
tensor launches the kernels or raises. ``plain=True`` asks for the plain
version explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mdfnet_tpu_torch.ops.cuda import build
from mdfnet_tpu_torch.ops.splat import splat_2d_plain
from mdfnet_tpu_torch.utils import tracing

# kernel launches since the last reset (the main-path check reads it); one
# per call, which launches the count, scan, bin, reduce and NaN kernels
LAUNCHES = {"splat_2d": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 2}   # g -> f32 output codes

# The plan's one source (csrc/splat_2d.cu takes it and checks it). A
# reduce block sums CPT channels (8, 16 or 32: the most of them that divide
# C) of a TILE_W x (8 * 32 / CPT) tile, 32 / CPT pixels a thread of 256, so
# its sums take 32 registers a thread; it sorts its bin in chunks of 256
# RS samples, RS (at most 4) as large as keeps its shared memory within
# REDUCE_SMEM, so that 3 blocks share an SM (csrc/splat_2d.cu Rows, which
# holds the kernel to the same). BIN_CHUNK: the samples of one count / bin
# block (8 warps of 4 rounds); MAX_TILES: the most tiles an image may have
# (the bin block keeps 8 counters a tile in shared memory).
TILE_W = 32
BIN_CHUNK = 1024
MAX_TILES = 6400
REDUCE_SMEM = 72 * 1024


def reduce_smem(rs: int, cpt: int, itemsize: int) -> int:
    """A reduce block's shared memory (csrc/splat_2d.cu reduce_smem) at RS
    samples a thread: 256 RS g rows at a stride of an odd number of 16-byte
    units, their weights (8 B), cell-order slots (2 B) and list entries (8
    B); the cells' and pixels' first slots and 32 ints (4 B each); 8 warps'
    counts per cell (2 B)."""
    row = cpt * itemsize
    stride = row if row // 16 % 2 else row + 16
    tile_h = 8 * 32 // cpt
    cells, pixels = (TILE_W + 1) * (tile_h + 1), TILE_W * tile_h
    return (256 * rs * (stride + 18) + (cells + 1 + pixels + 1 + 32) * 4
            + 8 * cells * 2)


@dataclass(frozen=True)
class SplatPlan:
    """How a call's samples are binned and reduced (``csrc/splat_2d.cu``).

    channels: a reduce block's channels (CPT); TILE_W x tile_h: a bin's and
    a reduce block's pixels; tiles_x, tiles_y: the tiles of one image
    (row-major); chunk, chunks: the count and bin blocks' samples and their
    number per image; reduce_chunk: the samples of a bin that a reduce
    block (256 threads) sorts at once (256 RS); entries: the bins' room (4
    a sample: a sample falls in at most 4 tiles)."""
    channels: int
    tile_h: int
    tiles_x: int
    tiles_y: int
    chunk: int
    chunks: int
    reduce_chunk: int
    entries: int

    @property
    def tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def splat_plan(batch: int, samples: int, height: int, width: int,
               channels: int, itemsize: int) -> SplatPlan:
    """The plan of a splat of ``batch`` images of ``samples`` samples of
    ``channels`` channels (``itemsize`` bytes each) onto ``height`` x
    ``width``; raises where the kernel cannot take it."""
    if channels <= 0 or channels % 8:
        raise ValueError(f"splat_plan: {channels} channels")
    cpt = next(c for c in (32, 16, 8) if channels % c == 0)
    tile_h = 8 * 32 // cpt
    tiles_x, tiles_y = -(-width // TILE_W), -(-height // tile_h)
    if tiles_x * tiles_y > MAX_TILES:
        raise ValueError(f"splat_2d: {height}x{width} makes "
                         f"{tiles_x * tiles_y} tiles of {TILE_W}x{tile_h}, "
                         f"more than {MAX_TILES}")
    return SplatPlan(channels=cpt, tile_h=tile_h,
                     tiles_x=tiles_x, tiles_y=tiles_y, chunk=BIN_CHUNK,
                     chunks=-(-samples // BIN_CHUNK),
                     reduce_chunk=256 * next(
                         rs for rs in (4, 3, 2, 1) if rs == 1 or reduce_smem(
                             rs, cpt, itemsize) <= REDUCE_SMEM),
                     entries=4 * batch * samples)


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
    with tracing.span("kernel/splat_2d"):
        plan = splat_plan(b, n, height, width, c, g.element_size())
        dev = g.device
        counts = torch.empty(b * plan.tiles * plan.chunks, dtype=torch.int32,
                             device=dev)
        starts = torch.empty(b * plan.tiles + 1, dtype=torch.int32,
                             device=dev)
        entries = torch.empty(plan.entries, dtype=torch.int32, device=dev)
        nan_list = torch.empty(b * n + 1, dtype=torch.int32, device=dev)
        out = torch.empty((b, height, width, c), dtype=torch.float32,
                          device=dev)
        for t, name in ((g, "g"), (x, "x"), (y, "y"), (counts, "counts"),
                        (starts, "starts"), (entries, "entries"),
                        (nan_list, "nan_list"), (out, "out")):
            build.check_operand(t, name)
        device, stream = build.launch_context(g)
        build.check(build.load_library().mdf_splat_2d(
            g.data_ptr(), x.data_ptr(), y.data_ptr(), counts.data_ptr(),
            starts.data_ptr(), entries.data_ptr(), nan_list.data_ptr(),
            out.data_ptr(), b, n, height, width, c, plan.channels,
            plan.tile_h, plan.reduce_chunk, plan.chunk, _DTYPES[g.dtype],
            device, stream), "splat_2d")
        LAUNCHES["splat_2d"] += 1
    return out
