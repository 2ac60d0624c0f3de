"""Group-wise vector cost aggregation over source views (port of
``mdfnet_tpu/models/aggregate.py``, reference net/unit/homoaggregate.py:8-46),
eval and train.

Features become per-group unit vectors by a softmax over each group's
channels; ref and each warped source are correlated per group; a tiny
1x1x1 Conv3d+BN+ReLU+Conv3d+sigmoid net (DepthWeight) gives each source a
per-voxel visibility weight for a weighted average. With C/G == 2 (the
reference configuration) the softmax collapses to sigmoids of channel-pair
differences and the whole eval chain is the fused aggregate kernel (K1);
the eval backbone then emits those differences itself (its out-convs
differenced, ``models/backbone.py``), which K1 takes as they come.

Train (C/G == 2) has two paths, as in JAX. With ``warp_impl="fused"``
(JAX ``aggregate.py:202-225``) it is the fused train aggregate
(``ops/aggregate_train.py``: the stats kernel, then K1 with a per-view BN
affine; a closed-form backward on K6 and K7), after which DepthWeight's
running statistics take the V sequential updates that the unfused path
makes. Otherwise (JAX ``aggregate.py:312-363``, and the JAX fallback of
``"fused"`` for C/G != 2) the chain stays unfused, so autograd reaches the
features: every source view's pair differences are warped by the
differentiable warp (K6 forward, K7 backward), and DepthWeight runs its
BatchNorm on batch statistics, one call (one running-statistics update) per
source view in view order.
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import BatchNorm, ConvND
from mdfnet_tpu_torch.ops.aggregate_train import rowsweep_aggregate_train
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
    """``warp_impl``: the JAX config's field; ``"fused"`` selects the fused
    train aggregate (C/G == 2); eval runs K1 whatever it says."""

    def __init__(self, ngroups: int, warp_impl: str = "dense"):
        super().__init__()
        self.ngroups = ngroups
        self.warp_impl = warp_impl
        self.depth_weight = DepthWeight(ngroups)

    def forward(self, feats: torch.Tensor, ref_proj: torch.Tensor,
                src_projs: torch.Tensor, depth_hypos: torch.Tensor,
                plain: bool = False, train: bool = False,
                diffs: bool = False) -> torch.Tensor:
        """
        Args:
            feats: (B, V, H, W, C) per-view features, view 0 = reference;
                with ``diffs`` (eval), (B, V, H, W, G) pair differences.
            ref_proj: (B, 4, 4); src_projs: (B, V-1, 4, 4).
            depth_hypos: (B, D, H, W) or (B, D, 1, 1).
        Returns:
            (B, D, H, W, G) f32 cost volume.
        """
        c, g = feats.shape[-1], self.ngroups
        if train and self.warp_impl == "fused" and c == 2 * g:
            return self._fused_train_path(feats, ref_proj, src_projs,
                                          depth_hypos, plain)
        if train:
            if c != 2 * g:
                raise NotImplementedError(
                    "the train aggregate takes C/G == 2 only")
            return self._train_path(feats, ref_proj, src_projs, depth_hypos,
                                    plain)
        if diffs or c == 2 * g:
            d = feats if diffs else feats[..., 0::2] - feats[..., 1::2]
            # no copy where the stack is dense (B = 1, a whole K4 output);
            # K1 takes dense operands, so a channel slice is copied
            return rowsweep_aggregate(
                d[:, 1:].contiguous(), d[:, 0].contiguous(), src_projs,
                ref_proj, depth_hypos, *self.depth_weight.fold(),
                plain=plain)
        if feats.is_cuda and not plain:
            raise NotImplementedError(
                "the CUDA aggregate kernel takes C/G == 2 only")
        return self._softmax_groups_path(feats.float(), ref_proj, src_projs,
                                         depth_hypos)

    def _fused_train_path(self, feats, ref_proj, src_projs, depth_hypos,
                          plain):
        """The fused train aggregate on the pair differences, then
        DepthWeight's BN running statistics: one update per source view in
        view order, from the stats kernel's batch statistics (JAX
        ``_ScalarFieldBN``, ``aggregate.py:62-74``)."""
        diffs = feats[..., 0::2] - feats[..., 1::2]          # (B, V, H, W, G)
        conv_bn, conv1 = self.depth_weight
        vol, stats = rowsweep_aggregate_train(
            diffs[:, 1:].contiguous(), diffs[:, 0].contiguous(), src_projs,
            ref_proj, depth_hypos, conv_bn.conv.weight.reshape(-1),
            conv_bn.bn.weight, conv_bn.bn.bias, conv1.weight.reshape(()),
            conv1.bias.reshape(()), plain=plain)
        conv_bn.bn.update_running_stats(stats[:, 0], stats[:, 1])
        return vol

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
