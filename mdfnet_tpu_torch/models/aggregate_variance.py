"""Variance cost aggregation (port of
``mdfnet_tpu/models/aggregate_variance.py``, reference
net/unit/homoaggregate.py:49-69): the alternative that
``aggregate_impl="variance"`` selects.

Each source's C-channel features are warped onto the reference's plane
sweep and softmaxed over their channels; the cost volume is the per-channel
variance over {ref} U {warped sources}, E[v^2] - E[v]^2, from running sums
in f32 (the reference features enter raw, as in the reference). Sources are
warped one at a time, as the JAX unit loops, so one source's volume is in
memory at a time. The warp is the sample kernel (K6) on the card; in
training its differentiable form (``ops/warp.py:_Sample``: K6 forward, the
splat kernel K7 backward).
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d
from mdfnet_tpu_torch.ops.warp import homography_warp_train, sweep_sample_coords


class VarianceAggregate(nn.Module):
    """Parameter-free; returns (B, D, H, W, C) f32."""

    def forward(self, feats: torch.Tensor, ref_proj: torch.Tensor,
                src_projs: torch.Tensor, depth_hypos: torch.Tensor,
                plain: bool = False, train: bool = False) -> torch.Tensor:
        """
        Args:
            feats: (B, V, H, W, C) per-view features, view 0 = reference.
            ref_proj: (B, 4, 4); src_projs: (B, V-1, 4, 4).
            depth_hypos: (B, D, H, W) or (B, D, 1, 1).
        """
        b, v, h, w, c = feats.shape
        vol_sum = feats[:, 0].float()[:, None]      # (B, 1, H, W, C)
        vol_sq_sum = vol_sum ** 2
        for s in range(v - 1):
            projs = src_projs[:, s:s + 1]
            if train:
                warped = homography_warp_train(
                    feats[:, s + 1:s + 2], projs, ref_proj, depth_hypos,
                    plain=plain)[:, 0]
            else:
                x, y = sweep_sample_coords(projs, ref_proj, depth_hypos, h, w)
                warped = sample_2d(feats[:, s + 1].contiguous(), x, y,
                                   plain=plain)
            warped = torch.softmax(warped.float(), dim=-1)
            vol_sum = vol_sum + warped
            vol_sq_sum = vol_sq_sum + warped ** 2
        return vol_sq_sum / v - (vol_sum / v) ** 2
