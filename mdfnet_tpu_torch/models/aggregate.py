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
makes. Otherwise (JAX ``aggregate.py:312-363``) the chain stays unfused, so
autograd reaches the features: every source view's pair differences are
warped by the differentiable warp (K6 forward, K7 backward), and
DepthWeight runs its BatchNorm on batch statistics, one call (one
running-statistics update) per source view in view order.

Any other C/G (JAX ``aggregate.py:291-365`` on ``homography_warp_pallas``)
warps each source's C channels with the sample kernel (K6; in training its
differentiable form, K7 backward), then takes the f32 group softmax and the
per-group inner product with the reference's unit vectors, in eval and in
training, whatever ``warp_impl`` says: JAX sends ``"fused"`` at C/G != 2 to
its dense warp, which computes the same warp.

Under spatial sharding of the eval forward (JAX ``aggregate.py:232-264,
303-310``) the reference grid is the rank's band and the sources are
all-gathered to full height (``halo.all_gather_rows``: the small 2D
features; the large volume stays sharded). The band's global offset reaches
the warps as an integer, rank x band rows (K1's ``row0``; the warps'
reference grid at K6), so every sample coordinate is the unsharded one.
"""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import BatchNorm, ConvND
from mdfnet_tpu_torch.ops.aggregate_train import rowsweep_aggregate_train
from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import rowsweep_aggregate
from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d
from mdfnet_tpu_torch.ops.warp import (homography_warp, homography_warp_train,
                                       sweep_sample_coords)
from mdfnet_tpu_torch.parallel import halo


def gathered_sources(src: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(the sources (B, S, H, W, C) at full height, the band's first row):
    all-gathered under spatial sharding, else as they are and 0."""
    ctx = halo.current_ctx()
    if ctx is None:
        return src, 0
    return halo.all_gather_rows(src, 2), ctx.rank * src.shape[2]


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
    train aggregate (C/G == 2); eval runs K1 (C/G == 2) or K6 whatever it
    says."""

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
        if c != 2 * g and not diffs:
            if plain and not train:
                return self._softmax_groups_path(
                    feats.float(), ref_proj, src_projs, depth_hypos)
            return self._groups_path(feats, ref_proj, src_projs, depth_hypos,
                                     plain, train)
        if train and self.warp_impl == "fused":
            return self._fused_train_path(feats, ref_proj, src_projs,
                                          depth_hypos, plain)
        if train:
            return self._train_path(feats, ref_proj, src_projs, depth_hypos,
                                    plain)
        d = feats if diffs else feats[..., 0::2] - feats[..., 1::2]
        # no copy where the stack is dense (B = 1, a whole K4 output); K1
        # takes dense operands, so a channel slice is copied
        src, row0 = gathered_sources(d[:, 1:])
        return rowsweep_aggregate(
            src.contiguous(), d[:, 0].contiguous(), src_projs, ref_proj,
            depth_hypos, *self.depth_weight.fold(), row0=row0, plain=plain)

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

    def _groups_path(self, feats, ref_proj, src_projs, depth_hypos, plain,
                     train):
        """General C/G on the sample kernel: each source's C channels
        warped (K6; in training K6 forward, K7 backward), the f32 group
        softmax, the per-group inner product with the reference's unit
        vectors, the DepthWeight-weighted mean in f32. One source at a
        time, as the JAX unit loops, so one source's volume is in memory
        at a time."""
        v, h, w = feats.shape[1:4]
        ref_unit = self._unit(feats[:, 0])[:, None]
        src, row0 = (feats[:, 1:], 0) if train else gathered_sources(
            feats[:, 1:])
        vol = wsum = 0.0
        for s in range(v - 1):
            projs = src_projs[:, s:s + 1]
            if train:
                warped = homography_warp_train(
                    feats[:, s + 1:s + 2], projs, ref_proj, depth_hypos,
                    plain=plain)[:, 0]
            else:
                x, y = sweep_sample_coords(projs, ref_proj, depth_hypos, h, w,
                                           src_height=src.shape[2], row0=row0)
                warped = sample_2d(src[:, s].contiguous(), x, y, plain=plain)
            sim = torch.sum(self._unit(warped) * ref_unit, dim=-1)
            wgt = self.depth_weight(sim, train=train)
            vol = vol + wgt[..., None] * sim
            wsum = wsum + wgt
        return vol / wsum[..., None]

    def _unit(self, x):
        """The f32 softmax over each group's C/G channels."""
        x = x.float()
        g = self.ngroups
        return torch.softmax(x.reshape(x.shape[:-1] + (g, x.shape[-1] // g)),
                             -1)

    def _softmax_groups_path(self, feats, ref_proj, src_projs, depth_hypos):
        """General C/G: group softmax + per-group inner product (reference
        homoaggregate.py:28-46), plain PyTorch on the gather warp; the
        plain version of the eval :meth:`_groups_path`."""
        ref_unit = self._unit(feats[:, 0])[:, None]
        src, row0 = gathered_sources(feats[:, 1:])
        vol = wsum = 0.0
        for s in range(feats.shape[1] - 1):
            warped = homography_warp(src[:, s], src_projs[:, s], ref_proj,
                                     depth_hypos, height=feats.shape[2],
                                     row0=row0)
            sim = torch.sum(self._unit(warped) * ref_unit, dim=-1)
            wgt = self.depth_weight(sim)
            vol = vol + wgt[..., None] * sim
            wsum = wsum + wgt
        return vol / wsum[..., None]
