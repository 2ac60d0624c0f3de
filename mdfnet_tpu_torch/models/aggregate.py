"""Group-wise vector cost aggregation over source views (port of
``mdfnet_tpu/models/aggregate.py``, reference net/unit/homoaggregate.py:8-46),
eval only.

Features become per-group unit vectors by a softmax over each group's
channels; ref and each warped source are correlated per group; a tiny
1x1x1 Conv3d+BN+ReLU+Conv3d+sigmoid net (DepthWeight) gives each source a
per-voxel visibility weight for a weighted average. With C/G == 2 (the
reference configuration) the softmax collapses to sigmoids of channel-pair
differences and the whole eval chain is the fused aggregate kernel (K1).

Train (C/G == 2, JAX ``aggregate.py:312-363``) keeps the chain unfused, so
autograd reaches the features: every source view's pair differences are
warped by the differentiable warp (K6 forward, K7 backward), and DepthWeight
runs its BatchNorm on batch statistics, one call (one running-statistics
update) per source view in view order.
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import BatchNorm, ConvND
from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import rowsweep_aggregate
from mdfnet_tpu_torch.ops.warp import homography_warp, homography_warp_train


class _ConvBN(nn.Module):
    """1x1x1 Conv3d (G -> 1, no bias) + BN: keys ``conv.weight``, ``bn.*``."""

    def __init__(self, ngroups: int):
        super().__init__()
        self.conv = ConvND(ngroups, 1, 1, ndim=3)
        self.bn = BatchNorm(1)


class DepthWeight(nn.Sequential):
    """sigmoid(Conv3d(G->1) -> BN -> ReLU -> Conv3d(1->1)) visibility net
    (reference homoaggregate.py:16-20), evaluated as a scalar field.
    Keys ``0.conv.weight``, ``0.bn.*``, ``1.weight``, ``1.bias``."""

    def __init__(self, ngroups: int):
        super().__init__(_ConvBN(ngroups), ConvND(1, 1, 1, ndim=3, bias=True))

    def fold(self):
        """(k0 (G,), bn_scale, bn_offset, k1, b1) in f32, the fused kernel's
        parameters."""
        bn_scale, bn_offset = self[0].bn.fold()
        return (self[0].conv.weight.float().reshape(-1), bn_scale[0],
                bn_offset[0], self[1].weight.float().reshape(()),
                self[1].bias.float()[0])

    def forward(self, sim: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Unfolded evaluation: sim (..., G) -> weights (...). ``train``:
        the BN normalises with this call's statistics over all of sim's
        leading axes."""
        s = (sim.float() * self[0].conv.weight.float().reshape(-1)).sum(-1)
        s = torch.relu(self[0].bn(s[..., None], train=train))[..., 0]
        return torch.sigmoid(s * self[1].weight.float().reshape(())
                             + self[1].bias.float()[0])


class VectorAggregate(nn.Module):
    def __init__(self, ngroups: int):
        super().__init__()
        self.ngroups = ngroups
        self.depth_weight = DepthWeight(ngroups)

    def forward(self, feats: torch.Tensor, ref_proj: torch.Tensor,
                src_projs: torch.Tensor, depth_hypos: torch.Tensor,
                plain: bool = False, train: bool = False) -> torch.Tensor:
        """
        Args:
            feats: (B, V, H, W, C) per-view features, view 0 = reference.
            ref_proj: (B, 4, 4); src_projs: (B, V-1, 4, 4).
            depth_hypos: (B, D, H, W) or (B, D, 1, 1).
        Returns:
            (B, D, H, W, G) f32 cost volume.
        """
        c, g = feats.shape[-1], self.ngroups
        if train:
            if c != 2 * g:
                raise NotImplementedError(
                    "the train aggregate takes C/G == 2 only")
            return self._train_path(feats, ref_proj, src_projs, depth_hypos,
                                    plain)
        if c == 2 * g:
            diffs = feats[..., 0::2] - feats[..., 1::2]     # (B, V, H, W, G)
            return rowsweep_aggregate(
                diffs[:, 1:].contiguous(), diffs[:, 0].contiguous(),
                src_projs, ref_proj, depth_hypos, *self.depth_weight.fold(),
                plain=plain)
        if feats.is_cuda and not plain:
            raise NotImplementedError(
                "the CUDA aggregate kernel takes C/G == 2 only")
        return self._softmax_groups_path(feats.float(), ref_proj, src_projs,
                                         depth_hypos)

    def _train_path(self, feats, ref_proj, src_projs, depth_hypos, plain):
        """sim = p q + (1-p)(1-q) with p = sigmoid(warped source pair
        differences), q = sigmoid(ref pair differences); the volume is the
        DepthWeight-weighted mean over the sources, in f32."""
        diffs = feats[..., 0::2] - feats[..., 1::2]          # (B, V, H, W, G)
        q = torch.sigmoid(diffs[:, 0].float())[:, None]    # (B, 1, H, W, G)
        warped = homography_warp_train(diffs[:, 1:], src_projs, ref_proj,
                                       depth_hypos, plain=plain)
        vol = wsum = 0.0
        for s in range(warped.shape[1]):
            p = torch.sigmoid(warped[:, s].float())       # (B, D, H, W, G)
            sim = p * q + (1.0 - p) * (1.0 - q)
            wgt = self.depth_weight(sim, train=True)
            vol = vol + wgt[..., None] * sim
            wsum = wsum + wgt
        return vol / wsum[..., None]

    def _softmax_groups_path(self, feats, ref_proj, src_projs, depth_hypos):
        """General C/G: group softmax + per-group inner product (reference
        homoaggregate.py:28-46), plain PyTorch."""
        b, v, h, w, c = feats.shape
        g = self.ngroups

        def unit(x):
            return torch.softmax(x.reshape(x.shape[:-1] + (g, c // g)), -1)

        ref_unit = unit(feats[:, 0])[:, None]
        vol = wsum = 0.0
        for s in range(v - 1):
            warped = homography_warp(feats[:, s + 1], src_projs[:, s],
                                     ref_proj, depth_hypos)
            sim = torch.sum(unit(warped) * ref_unit, dim=-1)
            wgt = self.depth_weight(sim)
            vol = vol + wgt[..., None] * sim
            wsum = wsum + wgt
        return vol / wsum[..., None]
