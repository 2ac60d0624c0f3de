"""Per-layer halo exchange for exact spatial (image-height) sharding of the
eval forward (counterpart of ``mdfnet_tpu/parallel/halo.py``).

Every rank holds one H-band of the images, features, cost volumes and
outputs. An H-stencil op exchanges exactly the rows it needs with the ranks
above and below instead of overlap-tiling, so the sharded forward is exact:

- a convolution extends its band by its halo rows, runs the unchanged
  kernel on the extended band and keeps the rows that the kernel's own
  zero padding did not touch (``models/layers.py``, :func:`banded`);
- the 2x bilinear upsamples exchange one row a side with replicated edges
  (``ops/sample.py``);
- the plane-sweep aggregates all-gather the small 2D source features and
  keep the large 3D volumes sharded (``models/aggregate.py``).

The context is a :class:`SpatialCtx` in a ``contextvars.ContextVar``, set by
:func:`spatial_sharding` around the model's forward (``parallel/spatial.py``),
so the model code stays unaware of the ranks except through these hooks.

Transport: one ``all_reduce(SUM)`` of a zeroed ``(n, bytes)`` int32 buffer
in which each rank fills its own slot with the raw bytes of what it sends
(design (b)). An integer sum with zeros is exact, so every value arrives
bit for bit (signed zeros and NaN payloads included), whatever its dtype.
The same call works on gloo with CUDA tensors (ranks that share a card:
NCCL refuses two ranks on one device; gloo's ``send``/``recv``/
``all_gather`` take CPU tensors only, its ``all_reduce`` CUDA tensors too)
and on NCCL with a card a rank; all compute stays on the rank's device. An
exchange moves a few hundred KB (one stage-0 volume row is 48 x 200 x 16
bf16 values); a gather of the source features a few tens of MB.
"""
from __future__ import annotations

import contextvars
import dataclasses
from contextlib import contextmanager

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SpatialCtx:
    """Active spatial sharding: the process group, this rank's index in it
    (its band is the rank-th from the top) and the number of bands."""
    group: object
    rank: int
    n: int


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "mdfnet_torch_spatial_ctx", default=None)

# all-reduces made by :func:`exchange` since the last reset, and the bytes
# this rank sent in them (its slot's)
EXCHANGES = {"calls": 0, "bytes": 0}


def current_ctx() -> SpatialCtx | None:
    return _CTX.get()


@contextmanager
def spatial_sharding(group):
    """Run the ops inside this scope band-wise over the ranks of ``group``
    (a one-rank group shards nothing)."""
    n = dist.get_world_size(group)
    ctx = SpatialCtx(group, dist.get_rank(group), n) if n > 1 else None
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def _require_ctx() -> SpatialCtx:
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("halo exchange outside a spatial_sharding scope")
    return ctx


def exchange(parts: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """Every rank's ``parts`` (each rank passes tensors of the same shapes
    and dtypes), as ``out[r][i]``, bit for bit: one all-reduce of the
    zeroed int32 buffer in which this rank fills slot ``rank``."""
    ctx = _require_ctx()
    flat = [p.contiguous().reshape(-1).view(torch.uint8) for p in parts]
    offsets, nbytes = [], 0
    for f in flat:
        offsets.append(nbytes)
        nbytes += -(-f.numel() // 8) * 8        # each part 8-byte aligned
    device = parts[0].device
    buf = torch.zeros((ctx.n, nbytes // 4), dtype=torch.int32, device=device)
    mine = buf[ctx.rank].view(torch.uint8)
    for f, off in zip(flat, offsets):
        mine[off:off + f.numel()] = f
    dist.all_reduce(buf, group=ctx.group)
    EXCHANGES["calls"] += 1
    EXCHANGES["bytes"] += sum(f.numel() for f in flat)
    out = []
    for r in range(ctx.n):
        slot = buf[r].view(torch.uint8)
        out.append([slot[off:off + f.numel()].view(p.dtype).view(p.shape)
                    for p, f, off in zip(parts, flat, offsets)])
    return out


def _neighbour_rows(x: torch.Tensor, h_axis: int, lo: int, hi: int):
    """(the ``lo`` last rows of the band above, the ``hi`` first rows of the
    band below), None where there is no such band or no row is asked for;
    every rank calls it with the same shapes."""
    ctx = _require_ctx()
    band = x.shape[h_axis]
    if lo > band or hi > band:
        raise ValueError(f"halo exchange: {lo}/{hi} halo rows exceed the "
                         f"band's {band}")
    sent = ([x.narrow(h_axis, band - lo, lo)] if lo else []) \
        + ([x.narrow(h_axis, 0, hi)] if hi else [])
    slots = exchange(sent) if sent else None
    r = ctx.rank
    above = slots[r - 1][0] if lo and r > 0 else None
    below = slots[r + 1][-1] if hi and r < ctx.n - 1 else None
    return above, below


def halo_exchange(x: torch.Tensor, h_axis: int, lo: int, hi: int,
                  edge: str = "zero") -> torch.Tensor:
    """The band ``x`` extended with ``lo`` rows of the rank above and ``hi``
    rows of the rank below (JAX ``halo.py:65-105``).

    ``edge="zero"``: the first rank receives zero rows from above and the
    last rank zero rows from below (a conv's zero padding, grid_sample's
    zeros). ``edge="replicate"``: those ranks repeat their own edge row
    instead (the clamped taps of the 2x bilinear upsample).
    """
    if edge not in ("zero", "replicate"):
        raise ValueError(f"halo_exchange: unknown edge {edge!r}")
    above, below = _neighbour_rows(x, h_axis, lo, hi)

    def fill(rows: int, edge_row: int) -> torch.Tensor:
        shape = (*x.shape[:h_axis], rows, *x.shape[h_axis + 1:])
        if edge == "replicate":
            return x.narrow(h_axis, edge_row, 1).expand(shape)
        return x.new_zeros(shape)
    parts = [above if above is not None else fill(lo, 0)] if lo else []
    parts.append(x)
    if hi:
        parts.append(below if below is not None
                     else fill(hi, x.shape[h_axis] - 1))
    return torch.cat(parts, dim=h_axis) if len(parts) > 1 else x


def all_gather_rows(x: torch.Tensor, h_axis: int) -> torch.Tensor:
    """The full height of a sharded tensor: every rank's band in rank
    order (for the warps' sources: 2D features, small next to the sharded
    3D volumes)."""
    _require_ctx()
    return torch.cat([s[0] for s in exchange([x])], dim=h_axis)


def extend_band(x: torch.Tensor, h_axis: int, lo: int, hi: int
                ) -> tuple[torch.Tensor, int]:
    """(the band with ``lo`` true rows above and ``hi`` below, dense; the
    rows added above). At the image's top and bottom edges nothing is
    added, so an op's own zero padding stands for the image's there, at
    every layer of a chain (the zero rows of :func:`halo_exchange` would
    stand in for the first layer's padding only)."""
    above, below = _neighbour_rows(x, h_axis, lo, hi)
    parts = [p for p in (above, x, below) if p is not None]
    ext = torch.cat(parts, dim=h_axis) if len(parts) > 1 else x
    return ext, 0 if above is None else lo


def banded(op, x: torch.Tensor, *, h_axis: int, lo: int, hi: int,
           stride: int = 1, up: int = 1,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``op(x, residual)`` for an H-stencil op with symmetric zero padding,
    run band-wise when a spatial context is active: the band is extended
    by ``lo`` rows above (rounded up to a multiple of ``stride``, so the
    output grid keeps its parity) and ``hi`` below (:func:`extend_band`),
    ``op`` runs unchanged on the extended band, and the output rows of the
    band are kept. ``stride``: the op's H stride (output row k reads input
    row stride k); ``up``: its H upsampling (a transposed conv: output rows
    up k, up k + 1 come from input row k). ``residual`` (the band's output
    shape) is padded with zero rows to the extended output, whose extra
    rows are dropped."""
    if current_ctx() is None:
        return op(x, residual)
    lo = -(-lo // stride) * stride
    band = x.shape[h_axis]
    ext, top = extend_band(x, h_axis, lo, hi)
    rows = -(-ext.shape[h_axis] // stride) * up
    first, keep = top // stride * up, band // stride * up
    if residual is not None:
        def zeros(n):
            shape = list(residual.shape)
            shape[h_axis] = n
            return residual.new_zeros(shape)
        residual = torch.cat([zeros(first), residual,
                              zeros(rows - first - keep)], h_axis)
    # the kernels take dense operands: the band's rows are copied out
    return op(ext, residual).narrow(h_axis, first, keep).contiguous()


def conv_halo(k: int, stride: int = 1) -> tuple[int, int]:
    """The rows above and below a band that a k x k conv with padding
    (k - 1) // 2 and ``stride`` reads for the band's outputs: output j
    reads input rows stride j - p .. stride j + p."""
    p = (k - 1) // 2
    return p, max(0, p - stride + 1)


def chain_halo(kernel_sizes, final_stride: int = 1) -> tuple[int, int]:
    """The receptive halo of a chain of stride-1 convs ending in one of
    ``final_stride`` (the conv chain kernel, K5): each earlier layer's
    padding on both sides, plus the last layer's :func:`conv_halo`."""
    earlier = sum((k - 1) // 2 for k in kernel_sizes[:-1])
    lo, hi = conv_halo(kernel_sizes[-1], final_stride)
    return earlier + lo, earlier + hi
