"""Exact spatial sharding of the eval forward over the image-height axis
(counterpart of ``mdfnet_tpu/parallel/spatial.py``).

One process a band: rank r of the group runs the model on rows [r H/n,
(r+1) H/n) of every view under :func:`halo.spatial_sharding`; the H-stencil
ops exchange their halo rows with the neighbouring ranks and the aggregates
sample all-gathered source features (``parallel/halo.py``). Each rank holds
1/n of the images, features, cost volumes and outputs; the result is the
unsharded forward's, with no overlap-tiling approximation.

Geometry: the cameras stay as they are. The band's global row offset
reaches the warps as an integer: an aggregate on a band of h rows at rank r
lays its reference grid on the source rows r h .. r h + h - 1 (K1's and the
warps' ``row0``), so the relative transforms, and with them every sample
coordinate, are bitwise the unsharded forward's (JAX shifts the reference
view's cy by -row0 instead, ``spatial.py:64-72``).

The units that JAX's sharding does not make exact are refused
(:func:`check_model`): the variance aggregate (it samples band-local
sources), RefineNet v1 (its align-corners upsample depends on the global
height) and the bicubic confidence EMA (a 4-tap stencil with no halo).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from mdfnet_tpu_torch.parallel import halo

# band starts must align with the deepest downsampling grid: the 1/8
# features further downsampled 4x (stage-0 3-scale U-Net) or the 1/4
# features downsampled 8x (4-scale U-Nets): 32 full-resolution rows
ALIGN = 32


def check_model(model) -> None:
    """Raise ``ValueError`` naming each unit of ``model`` (a CoreNet) that
    spatial sharding does not compute exactly."""
    from mdfnet_tpu_torch.models.aggregate_variance import VarianceAggregate
    from mdfnet_tpu_torch.models.refine import RefineNet
    refused = []
    if any(isinstance(m, VarianceAggregate) for m in model.Homoaggre):
        refused.append("the variance aggregate (aggregate_impl='variance')")
    if isinstance(model.Refine, RefineNet):
        refused.append("RefineNet v1 (refine_impl='refine1')")
    if refused:
        raise ValueError("spatial sharding is not exact for "
                         + " and ".join(refused))


def band_rows(height: int, n: int, rank: int) -> slice:
    """Rank ``rank``'s rows of an image of ``height`` rows over ``n``
    ranks; ``height`` must divide n * ALIGN."""
    if height % (n * ALIGN):
        raise ValueError(f"spatial sharding: H={height} is not a multiple "
                         f"of {n} x {ALIGN}")
    band = height // n
    return slice(rank * band, (rank + 1) * band)


def spatial_eval_forward(model, imgs: torch.Tensor, extrinsics: torch.Tensor,
                         intrinsics: torch.Tensor, depth_range: torch.Tensor,
                         group) -> dict:
    """The eval forward of ``model`` with H sharded over the ranks of
    ``group``; every rank calls it with the same full inputs, which may lie
    on the host: only the rank's band of the images goes to its device.

    Args:
        imgs: (B, V, H, W, 3), H a multiple of n x ALIGN.
        extrinsics, intrinsics, depth_range: as ``CoreNet.forward``.
    Returns:
        {"depth": (B, H, W), "confidence": (B, H, W)} at full height on
        every rank, and "coverage_ok", always True (the port's warps have
        no window contract).
    """
    check_model(model)
    n = dist.get_world_size(group)
    rows = band_rows(imgs.shape[2], n, dist.get_rank(group))
    device = next(model.parameters()).device
    with halo.spatial_sharding(group):
        out = model(*(a.to(device) for a in (imgs[:, :, rows], extrinsics,
                                             intrinsics, depth_range)))
        if n > 1:
            depth = halo.all_gather_rows(out["depth"], 1)
            confidence = halo.all_gather_rows(out["confidence"], 1)
        else:
            depth, confidence = out["depth"], out["confidence"]
    return {"depth": depth, "confidence": confidence,
            "coverage_ok": out["coverage_ok"]}
