"""Fused plane-sweep warp + vector aggregation (K1): CUDA kernel and its plain
PyTorch version.

Port of ``mdfnet_tpu/ops/pallas/aggregate_kernel.py:427`` (``rowsweep_aggregate``)
for the C/G == 2 configuration, where the group softmax collapses to sigmoids
of channel-pair differences: ``softmax([a, b]) == [sigmoid(a-b),
sigmoid(b-a)]``, so only the G difference channels are warped. The kernel
(``csrc/rowsweep_aggregate.cu``) has no source window, so unlike the TPU
kernel it needs no coverage contract: it is exact for any camera.

A CPU tensor takes :func:`rowsweep_aggregate_plain`; a CUDA tensor launches
the kernel or raises. ``plain=True`` asks for the plain version explicitly
(used to compare the two on the card).
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops.cuda import build, exact_cuda_math
from mdfnet_tpu_torch.ops.warp import homography_warp

# kernel launches since the last reset (the main-path check reads it)
LAUNCHES = {"rowsweep_aggregate": 0}

_GROUPS = (8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 2}   # input -> f32 output codes


def depth_weight_folded(sim: torch.Tensor, k0, bn_scale, bn_offset, k1,
                        b1) -> torch.Tensor:
    """DepthWeight with its eval BN folded: sigmoid(k1 relu(bn_s (sim . k0)
    + bn_o) + b1). sim (..., G) -> (...)."""
    s = (sim * k0.float()).sum(-1)
    return torch.sigmoid(k1 * torch.relu(s * bn_scale + bn_offset) + b1)


def rowsweep_aggregate_plain(src_diffs, ref_diffs, src_projs, ref_proj,
                             depth_hypos, k0, bn_scale, bn_offset, k1, b1):
    """Plain PyTorch version of :func:`rowsweep_aggregate` (f32 math): the
    gather warp of ``ops/warp.py`` followed by the aggregation."""
    if src_diffs.is_cuda:
        exact_cuda_math()
    q = torch.sigmoid(ref_diffs.float())[:, None]          # (B, 1, H, W, G)
    vol = wsum = 0.0
    for s in range(src_diffs.shape[1]):
        p = torch.sigmoid(homography_warp(src_diffs[:, s].float(),
                                          src_projs[:, s], ref_proj,
                                          depth_hypos))
        sim = p * q + (1.0 - p) * (1.0 - q)
        wgt = depth_weight_folded(sim, k0, bn_scale, bn_offset, k1, b1)
        vol = vol + wgt[..., None] * sim
        wsum = wsum + wgt
    return vol / wsum[..., None]


def rowsweep_aggregate(src_diffs: torch.Tensor, ref_diffs: torch.Tensor,
                       src_projs: torch.Tensor, ref_proj: torch.Tensor,
                       depth_hypos: torch.Tensor, k0: torch.Tensor, bn_scale,
                       bn_offset, k1, b1, *, plain: bool = False
                       ) -> torch.Tensor:
    """Warp S sources onto D planes and aggregate them into a cost volume.

    Args:
        src_diffs: (B, S, H, W, G) source pair differences (even minus odd
            channels), bf16 or f32.
        ref_diffs: (B, H, W, G) reference pair differences, same dtype.
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
                                        bn_offset, k1, b1)
    b, n_src, h, w, g = src_diffs.shape
    d = depth_hypos.shape[1]
    if g not in _GROUPS:
        raise ValueError(f"rowsweep_aggregate: G={g} not in {_GROUPS}")
    if src_diffs.dtype not in _DTYPES or ref_diffs.dtype != src_diffs.dtype:
        raise ValueError("rowsweep_aggregate: diffs must both be bf16 or f32")
    if ref_diffs.shape != (b, h, w, g):
        raise ValueError(f"rowsweep_aggregate: ref_diffs {tuple(ref_diffs.shape)}"
                         f" does not match {(b, h, w, g)}")
    per_pixel = depth_hypos.shape[-2:] != (1, 1)
    if depth_hypos.shape != ((b, d, h, w) if per_pixel else (b, d, 1, 1)):
        raise ValueError(f"rowsweep_aggregate: depth_hypos "
                         f"{tuple(depth_hypos.shape)} does not match the grid")
    rel = geometry.relative_transforms(src_projs, ref_proj).contiguous()
    hypos = depth_hypos.float().contiguous()
    params = torch.cat([torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                                     device=src_diffs.device)
                                     for v in (bn_scale, bn_offset, k1, b1)]),
                        k0.float().reshape(g)])
    out = torch.empty((b, d, h, w, g), dtype=torch.float32,
                      device=src_diffs.device)
    for t, name in ((src_diffs, "src_diffs"), (ref_diffs, "ref_diffs"),
                    (rel, "rel"), (hypos, "depth_hypos"), (params, "params"),
                    (out, "out")):
        build.check_operand(t, name)
    device, stream = build.launch_context(src_diffs)
    lib = build.load_library()
    err = lib.mdf_rowsweep_aggregate(
        src_diffs.data_ptr(), ref_diffs.data_ptr(), rel.data_ptr(),
        hypos.data_ptr(), params.data_ptr(), out.data_ptr(),
        b, n_src, d, h, w, g, int(per_pixel), _DTYPES[src_diffs.dtype],
        w / (w - 1.0), h / (h - 1.0), device, stream)
    build.check(err, "rowsweep_aggregate")
    LAUNCHES["rowsweep_aggregate"] += 1
    return out
