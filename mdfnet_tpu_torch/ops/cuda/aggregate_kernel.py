"""Fused plane-sweep warp + vector aggregation (K1, eval and train) and the
batch statistics of the train-mode fused aggregate (the stats kernel of K9):
CUDA kernels and their plain PyTorch versions.

Port of ``mdfnet_tpu/ops/pallas/aggregate_kernel.py:427``
(``rowsweep_aggregate``, also with ``with_wsum=True`` and a per-view BN
affine) and ``:604`` (``rowsweep_stats``) for the C/G == 2 configuration,
where the group softmax collapses to sigmoids of channel-pair differences:
``softmax([a, b]) == [sigmoid(a-b), sigmoid(b-a)]``, so only the G difference
channels are warped. Both kernels (``csrc/rowsweep_aggregate.cu``, whose
blocks walk runs of planes (:func:`aggregate_plan`), and
``csrc/rowsweep_stats.cu``, whose blocks walk all planes
(:func:`stats_plan`)) run one chain on groups of G / 8 lanes a pixel, so the
statistics describe exactly the field that K1 normalises. They have no
source window, so unlike the TPU kernels they need no coverage contract:
they are exact for any camera.

Under spatial sharding (``parallel/spatial.py``) the eval kernel takes a
reference band: its grid is the H rows from the source images' row
``row0``, the sources are the all-gathered Hs full-height rows, and every
source bound and the grid convention's normalisation use Hs, as the JAX
kernel's source height does (``aggregate_kernel.py:298,376,439``). The
train launch and the stats kernel keep Hs == H (the JAX package has no
spatial training).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``plain=True`` asks for the plain version explicitly (used to compare
the two on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops.cuda import build, exact_cuda_math
from mdfnet_tpu_torch.ops.warp import homography_warp
from mdfnet_tpu_torch.utils import tracing

# kernel launches since the last reset (the main-path check reads them)
LAUNCHES = {"rowsweep_aggregate": 0, "rowsweep_aggregate_with_wsum": 0,
            "rowsweep_stats": 0}

_GROUPS = (8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 2}   # input -> f32 output codes
_STATS_BLOCK = 128          # threads per block of csrc/rowsweep_stats.cu
_AGG_BLOCK = 128            # threads per block of csrc/rowsweep_aggregate.cu
_AGG_PLANES = 8             # planes per lane group there, at most


class AggregatePlan(NamedTuple):
    """K1's launch (csrc/rowsweep_aggregate.cu): a group of ``lanes`` lanes
    per pixel, each owning 8 of its G channels; a block covers ``pixels``
    consecutive pixels of the flattened H x W and a run of ``planes``
    planes; ``blocks`` blocks in all."""
    lanes: int
    pixels: int
    planes: int
    blocks: int


def aggregate_plan(b: int, d: int, h: int, w: int, g: int) -> AggregatePlan:
    """K1's launch plan for a (B, D, H, W, G) volume; the kernel checks that
    ``planes`` and ``blocks`` are its own."""
    lanes = g // 8
    pixels = _AGG_BLOCK // lanes
    planes = min(_AGG_PLANES, d)
    return AggregatePlan(lanes, pixels, planes,
                         b * -(-d // planes) * -(-(h * w) // pixels))


class StatsPlan(NamedTuple):
    """The stats kernel's launch (csrc/rowsweep_stats.cu): K1's lane
    groups (``lanes`` lanes a pixel, 8 channels each); a block covers
    ``pixels`` consecutive pixels of one item's flattened H x W and walks
    all ``planes`` planes; ``blocks`` blocks in all, ``blocks`` partial
    sums per source."""
    lanes: int
    pixels: int
    planes: int
    blocks: int


def stats_plan(b: int, d: int, h: int, w: int, g: int) -> StatsPlan:
    """The stats kernel's launch plan for a (B, D, H, W, G) sweep; the
    kernel checks that ``blocks`` is its own. It follows from the shape
    alone, so the order of the f64 sums does not depend on the card."""
    lanes = g // 8
    pixels = _STATS_BLOCK // lanes
    return StatsPlan(lanes, pixels, d, b * -(-(h * w) // pixels))


def depth_weight_folded(sim: torch.Tensor, k0, bn_scale, bn_offset, k1,
                        b1) -> torch.Tensor:
    """DepthWeight with its BN as an affine: sigmoid(k1 relu(bn_s (sim .
    k0) + bn_o) + b1). sim (..., G) -> (...)."""
    s = (sim * k0.float()).sum(-1)
    return torch.sigmoid(k1 * torch.relu(s * bn_scale + bn_offset) + b1)


def _similarities(src_diffs, ref_diffs, src_projs, ref_proj, depth_hypos,
                  row0: int = 0):
    """Per source view, sim = p q + (1-p)(1-q) (B, D, H, W, G) in f32, from
    the gather warp of ``ops/warp.py``: the plain versions' shared chain.
    The reference grid is ref_diffs' H rows from the sources' row
    ``row0``."""
    if src_diffs.is_cuda:
        exact_cuda_math()
    q = torch.sigmoid(ref_diffs.float())[:, None]          # (B, 1, H, W, G)
    for s in range(src_diffs.shape[1]):
        p = torch.sigmoid(homography_warp(
            src_diffs[:, s].float(), src_projs[:, s], ref_proj, depth_hypos,
            height=ref_diffs.shape[1], row0=row0))
        yield p * q + (1.0 - p) * (1.0 - q)


def _aggregate_plain(src_diffs, ref_diffs, src_projs, ref_proj, depth_hypos,
                     k0, bn_s, bn_o, k1, b1, row0: int = 0):
    """(volume, weight sum) with source view s normalised by (bn_s[s],
    bn_o[s])."""
    vol = wsum = 0.0
    for s, sim in enumerate(_similarities(src_diffs, ref_diffs, src_projs,
                                          ref_proj, depth_hypos, row0)):
        wgt = depth_weight_folded(sim, k0, bn_s[s], bn_o[s], k1, b1)
        vol = vol + wgt[..., None] * sim
        wsum = wsum + wgt
    return vol / wsum[..., None], wsum


def rowsweep_aggregate_plain(src_diffs, ref_diffs, src_projs, ref_proj,
                             depth_hypos, k0, bn_scale, bn_offset, k1, b1,
                             row0: int = 0):
    """Plain PyTorch version of :func:`rowsweep_aggregate` (f32 math): the
    gather warp of ``ops/warp.py`` followed by the aggregation."""
    n_src = src_diffs.shape[1]
    return _aggregate_plain(src_diffs, ref_diffs, src_projs, ref_proj,
                            depth_hypos, k0, [bn_scale] * n_src,
                            [bn_offset] * n_src, k1, b1, row0)[0]


def rowsweep_aggregate_with_wsum_plain(src_diffs, ref_diffs, src_projs,
                                       ref_proj, depth_hypos, k0, bn_s, bn_o,
                                       k1, b1):
    """Plain PyTorch version of :func:`rowsweep_aggregate_with_wsum`."""
    return _aggregate_plain(src_diffs, ref_diffs, src_projs, ref_proj,
                            depth_hypos, k0, bn_s.float(), bn_o.float(), k1,
                            b1)


def rowsweep_stats_plain(src_diffs, ref_diffs, src_projs, ref_proj,
                         depth_hypos, k0) -> torch.Tensor:
    """Plain PyTorch version of :func:`rowsweep_stats`: the f32 field, its
    sums in f64."""
    rows = []
    for sim in _similarities(src_diffs, ref_diffs, src_projs, ref_proj,
                             depth_hypos):
        field = (sim * k0.float()).sum(-1).double()
        rows.append(torch.stack([field.sum(), (field * field).sum()]))
    return torch.stack(rows)


def _check_inputs(name, src_diffs, ref_diffs, depth_hypos,
                  band: bool = False):
    """(B, S, D, H, W, G, per_pixel, Hs): H is the reference grid's rows,
    Hs the sources'; they differ only for a ``band`` launch."""
    b, n_src, hs, w, g = src_diffs.shape
    h = ref_diffs.shape[1] if band else hs
    d = depth_hypos.shape[1]
    if g not in _GROUPS:
        raise ValueError(f"{name}: G={g} not in {_GROUPS}")
    if src_diffs.dtype not in _DTYPES or ref_diffs.dtype != src_diffs.dtype:
        raise ValueError(f"{name}: diffs must both be bf16 or f32")
    if ref_diffs.shape != (b, h, w, g):
        raise ValueError(f"{name}: ref_diffs {tuple(ref_diffs.shape)} does "
                         f"not match {(b, h, w, g)}")
    per_pixel = depth_hypos.shape[-2:] != (1, 1)
    if depth_hypos.shape != ((b, d, h, w) if per_pixel else (b, d, 1, 1)):
        raise ValueError(f"{name}: depth_hypos {tuple(depth_hypos.shape)} "
                         "does not match the grid")
    return b, n_src, d, h, w, g, per_pixel, hs


def _scalars(device, *values) -> torch.Tensor:
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device).reshape(())
                        for v in values])


def _launch_aggregate(src_diffs, ref_diffs, src_projs, ref_proj, depth_hypos,
                      k0, bn_scale, bn_offset, k1, b1, *, train: bool,
                      row0: int = 0):
    """One launch of K1; ``train``: bn_scale/bn_offset are (S,) and the
    weight sum is returned too; else the reference grid may be a band of
    the sources' rows from ``row0``."""
    name = "rowsweep_aggregate_with_wsum" if train else "rowsweep_aggregate"
    b, n_src, d, h, w, g, per_pixel, hs = _check_inputs(
        name, src_diffs, ref_diffs, depth_hypos, band=not train)
    with tracing.span("kernel/rowsweep_aggregate_train" if train
                      else "kernel/rowsweep_aggregate"):
        dev = src_diffs.device
        rel = geometry.relative_transforms(src_projs, ref_proj).contiguous()
        hypos = depth_hypos.float().contiguous()
        out = torch.empty((b, d, h, w, g), dtype=torch.float32, device=dev)
        operands = [(src_diffs, "src_diffs"), (ref_diffs, "ref_diffs"),
                    (rel, "rel"), (hypos, "depth_hypos"), (out, "out")]
        if train:
            with tracing.span("prep"):
                params = torch.cat([_scalars(dev, 0.0, 0.0, k1, b1),
                                    k0.detach().float().reshape(g)])
            bn = torch.cat([bn_scale.detach().float().reshape(n_src),
                            bn_offset.detach().float().reshape(n_src)])
            wsum = torch.empty((b, d, h, w), dtype=torch.float32, device=dev)
            operands += [(params, "params"), (bn, "bn"), (wsum, "wsum")]
        else:
            with tracing.span("prep"):
                params = torch.cat([_scalars(dev, bn_scale, bn_offset, k1,
                                             b1), k0.float().reshape(g)])
            operands.append((params, "params"))
        for t, tname in operands:
            build.check_operand(t, tname)
        device, stream = build.launch_context(src_diffs)
        lib = build.load_library()
        plan = aggregate_plan(b, d, h, w, g)
        # the grid convention normalises by the source's extent
        tail = (int(per_pixel), plan.planes, plan.blocks,
                _DTYPES[src_diffs.dtype], w / (w - 1.0), hs / (hs - 1.0),
                device, stream)
        if train:
            err = lib.mdf_rowsweep_aggregate_train(
                src_diffs.data_ptr(), ref_diffs.data_ptr(), rel.data_ptr(),
                hypos.data_ptr(), params.data_ptr(), bn.data_ptr(),
                out.data_ptr(), wsum.data_ptr(), b, n_src, d, h, w, g, *tail)
        else:
            err = lib.mdf_rowsweep_aggregate(
                src_diffs.data_ptr(), ref_diffs.data_ptr(), rel.data_ptr(),
                hypos.data_ptr(), params.data_ptr(), out.data_ptr(), b, n_src,
                d, h, w, g, hs, int(row0), *tail)
        build.check(err, name)
        LAUNCHES[name] += 1
    return (out, wsum) if train else out


def rowsweep_aggregate(src_diffs: torch.Tensor, ref_diffs: torch.Tensor,
                       src_projs: torch.Tensor, ref_proj: torch.Tensor,
                       depth_hypos: torch.Tensor, k0: torch.Tensor, bn_scale,
                       bn_offset, k1, b1, *, row0: int = 0,
                       plain: bool = False) -> torch.Tensor:
    """Warp S sources onto D planes and aggregate them into a cost volume.

    Args:
        src_diffs: (B, S, Hs, W, G) source pair differences (even minus odd
            channels), bf16 or f32.
        ref_diffs: (B, H, W, G) reference pair differences, same dtype: the
            reference grid, rows row0 .. row0 + H - 1 of the sources' Hs
            (H == Hs and row0 == 0 but under spatial sharding).
        src_projs: (B, S, 4, 4); ref_proj: (B, 4, 4).
        depth_hypos: (B, D, H, W) or (B, D, 1, 1).
        k0: (G,) DepthWeight conv0 weights; bn_scale, bn_offset: its folded
            eval BN; k1, b1: its conv1 weight and bias (0-d tensors).
    Returns:
        (B, D, H, W, G) f32 volume sum_s w_s sim_s / sum_s w_s.
    """
    if plain or not src_diffs.is_cuda:
        return rowsweep_aggregate_plain(src_diffs, ref_diffs, src_projs,
                                        ref_proj, depth_hypos, k0, bn_scale,
                                        bn_offset, k1, b1, row0)
    return _launch_aggregate(src_diffs, ref_diffs, src_projs, ref_proj,
                             depth_hypos, k0, bn_scale, bn_offset, k1, b1,
                             train=False, row0=row0)


def rowsweep_aggregate_with_wsum(src_diffs: torch.Tensor,
                                 ref_diffs: torch.Tensor,
                                 src_projs: torch.Tensor,
                                 ref_proj: torch.Tensor,
                                 depth_hypos: torch.Tensor, k0: torch.Tensor,
                                 bn_s: torch.Tensor, bn_o: torch.Tensor, k1,
                                 b1, *, plain: bool = False
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The aggregation pass of the train-mode fused aggregate: K1 with a
    per-source-view BN affine, which also returns the weight sum.

    Args as :func:`rowsweep_aggregate`, except bn_s, bn_o: (S,) the affine
    that normalises source view s with its batch statistics.
    Returns:
        (volume (B, D, H, W, G) f32, weight sum sum_s w_s (B, D, H, W) f32).
    """
    if plain or not src_diffs.is_cuda:
        return rowsweep_aggregate_with_wsum_plain(
            src_diffs, ref_diffs, src_projs, ref_proj, depth_hypos, k0, bn_s,
            bn_o, k1, b1)
    return _launch_aggregate(src_diffs, ref_diffs, src_projs, ref_proj,
                             depth_hypos, k0, bn_s, bn_o, k1, b1, train=True)


def rowsweep_stats(src_diffs: torch.Tensor, ref_diffs: torch.Tensor,
                   src_projs: torch.Tensor, ref_proj: torch.Tensor,
                   depth_hypos: torch.Tensor, k0: torch.Tensor, *,
                   plain: bool = False) -> torch.Tensor:
    """Per source view, (sum s, sum s^2) of DepthWeight's pre-BN field s =
    k0 . sim over the whole batch's (B, D, H, W) plane sweep: the batch
    statistics that train-mode BN normalises s with.

    Args as :func:`rowsweep_aggregate` without the BN and conv1 scalars.
    Returns:
        (S, 2) float64 sums; two launches on the same inputs give
        bit-identical sums.
    """
    if plain or not src_diffs.is_cuda:
        return rowsweep_stats_plain(src_diffs, ref_diffs, src_projs,
                                    ref_proj, depth_hypos, k0)
    b, n_src, d, h, w, g, per_pixel, _ = _check_inputs(
        "rowsweep_stats", src_diffs, ref_diffs, depth_hypos)
    with tracing.span("kernel/rowsweep_stats"):
        dev = src_diffs.device
        rel = geometry.relative_transforms(src_projs, ref_proj).contiguous()
        hypos = depth_hypos.float().contiguous()
        with tracing.span("prep"):
            k0f = k0.detach().float().reshape(g).contiguous()
        plan = stats_plan(b, d, h, w, g)
        partial = torch.empty((n_src, plan.blocks, 2), dtype=torch.float64,
                              device=dev)
        out = torch.empty((n_src, 2), dtype=torch.float64, device=dev)
        for t, name in ((src_diffs, "src_diffs"), (ref_diffs, "ref_diffs"),
                        (rel, "rel"), (hypos, "depth_hypos"), (k0f, "k0"),
                        (partial, "partial"), (out, "out")):
            build.check_operand(t, name)
        device, stream = build.launch_context(src_diffs)
        lib = build.load_library()
        err = lib.mdf_rowsweep_stats(
            src_diffs.data_ptr(), ref_diffs.data_ptr(), rel.data_ptr(),
            hypos.data_ptr(), k0f.data_ptr(), partial.data_ptr(),
            out.data_ptr(), b, n_src, d, h, w, g, int(per_pixel),
            _DTYPES[src_diffs.dtype], w / (w - 1.0), h / (h - 1.0),
            plan.blocks, device, stream)
        build.check(err, "rowsweep_stats")
        LAUNCHES["rowsweep_stats"] += 1
    return out
