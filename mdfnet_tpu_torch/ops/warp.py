"""Plane-sweep homography warp by gather (port of ``mdfnet_tpu/ops/warp.py``).

This is the plain version behind the fused aggregate kernel
(``ops/cuda/aggregate_kernel.py``): coordinates in f32 whatever the feature
type, the reference's sampling convention via
:func:`mdfnet_tpu_torch.geometry.reference_grid_coords`.
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d


def homography_warp(src_feat: torch.Tensor, src_proj: torch.Tensor,
                    ref_proj: torch.Tensor,
                    depth_hypos: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) source features onto the ref plane sweep.

    Args:
        src_proj, ref_proj: (B, 4, 4).
        depth_hypos: (B, D, H, W) or (B, D, 1, 1).
    Returns:
        (B, D, H, W, C) warped volume.
    """
    b, h, w, c = src_feat.shape
    d = depth_hypos.shape[1]
    x_src, y_src = geometry.sweep_coordinates(src_proj, ref_proj,
                                              depth_hypos, h, w)
    x_eff, y_eff = geometry.reference_grid_coords(x_src, y_src, h, w)
    warped = bilinear_sample_2d(src_feat, x_eff, y_eff)    # (B, D, H*W, C)
    return warped.reshape(b, d, h, w, c)
