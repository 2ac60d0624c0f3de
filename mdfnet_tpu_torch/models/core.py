"""CoreNet — the 4-scale coarse-to-fine plane-sweep cascade (port of
``mdfnet_tpu/models/core.py``, reference net/core.py:4-78): the eval forward
and, with ``train=True``, the training forward.

Channels-last: imgs (B, V, H, W, 3); features (B*V, h, w, C); cost volumes
(B, D, h, w, G); probability volumes (B, D, h, w). The submodules carry the
reference ``state_dict`` names (``Backbone``, ``Homoaggre``, ``Regular``,
``Refine``), so reference ``.pth`` files and JAX-exported weights load with
``load_state_dict(strict=True)``.

Under ``remat`` (JAX ``core.py:84-103``: ``nn.remat``), training wraps the
backbone, each aggregate and each U-Net in
``torch.utils.checkpoint.checkpoint``: the backward recomputes their
activations instead of keeping them. The recomputation runs with every
BatchNorm inside the block marked ``recomputing``, so the running
statistics take the first pass's update only, as JAX's remat keeps the
first pass's ``batch_stats``. The parameters and the state_dict are the
same either way.

Under spatial sharding (``parallel/spatial.py``: ``imgs`` is the rank's
H-band, JAX ``core.py:155-180``) the eval forward runs as it is: its
H-stencil ops exchange halo rows (``parallel/halo.py``), the aggregates
sample all-gathered sources, and the hypotheses, regressions and
confidence are pointwise or go through the hooked upsamples. The units
that are not exact there raise ``ValueError``, and so does training.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.models.aggregate import VectorAggregate
from mdfnet_tpu_torch.models.aggregate_variance import VarianceAggregate
from mdfnet_tpu_torch.models.backbone import FPN4Scales
from mdfnet_tpu_torch.models.layers import BatchNorm
from mdfnet_tpu_torch.models.refine import RefineNet, RefineNet2
from mdfnet_tpu_torch.models.regularize import (RegularNet3Scales,
                                                RegularNet4Scales)
from mdfnet_tpu_torch.ops.fitting import (atv_hypos, refined_hypotheses,
                                          uniform_hypotheses)
from mdfnet_tpu_torch.ops.regress import (confidence_regression,
                                          depth_regression)
from mdfnet_tpu_torch.ops.sample import resize_bilinear_2x, resize_nearest_2x
from mdfnet_tpu_torch.parallel import halo


class CoreNet(nn.Module):
    """FPN features -> per stage (hypotheses, warp + aggregate, 3D U-Net,
    soft-argmax) -> PixelShuffle refinement.

    The topology comes from ``ModelConfig`` (through
    ``registry.build_model``). ``dtype`` is the conv compute dtype; geometry,
    softmax, fitting and regression run in f32. ``warp_impl="fused"``
    trains the aggregates on the fused train aggregate (K9). The
    alternative units, as JAX ``core.py:78-132,203-238`` builds them:
    ``aggregate_impl="variance"`` (the U-Nets then take C channels, not
    G), ``hypo_impl="atv"`` (adaptive-thin-volume hypotheses from stage 1
    on) and ``refine_impl="refine1"`` (RefineNet v1, which also takes the
    reference image). ``remat``: recompute the blocks JAX's remat wraps in
    the training backward.
    """

    def __init__(self, *, chs: Sequence[int], ndepths: Sequence[int],
                 curve_classes: Sequence[str | None],
                 prob_threshs: Sequence[float], ngroups: Sequence[int],
                 dtype: torch.dtype, warp_impl: str = "dense",
                 aggregate_impl: str = "vector", hypo_impl: str = "fit",
                 refine_impl: str = "refine2", remat: bool = False):
        super().__init__()
        self.remat = remat
        self.ndepths = tuple(ndepths)
        self.curve_classes = tuple(curve_classes)
        self.prob_threshs = tuple(prob_threshs)
        self.dtype = dtype
        self.hypo_impl = hypo_impl
        nstages = len(self.ndepths)
        vector = aggregate_impl == "vector"
        # the eval backbone emits the pair differences where the vector
        # aggregate consumes only those (C == 2G at every stage)
        self.Backbone = FPN4Scales(tuple(chs), emit_diffs=vector and all(
            chs[len(chs) - 1 - s] == 2 * ngroups[s] for s in range(nstages)))
        self.Homoaggre = nn.ModuleList(
            VectorAggregate(ngroups[s], warp_impl) if vector
            else VarianceAggregate() for s in range(nstages))
        # the U-Nets' input channels: G (vector) or C (variance)
        cin = [ngroups[s] if vector else chs[len(chs) - 1 - s]
               for s in range(nstages)]
        self.Regular = nn.ModuleList(
            [RegularNet3Scales(cin[0], 16)]
            + [RegularNet4Scales(cin[s], 8) for s in range(1, nstages)])
        self.Refine = RefineNet2() if refine_impl == "refine2" \
            else RefineNet()

    def forward(self, imgs: torch.Tensor, extrinsics: torch.Tensor,
                intrinsics: torch.Tensor, depth_range: torch.Tensor,
                plain: bool = False, train: bool = False) -> dict:
        """
        Args:
            imgs: (B, V, H, W, 3) images, view 0 = reference.
            extrinsics: (B, V, 4, 4); intrinsics: (B, V, 3, 3).
            depth_range: (B, 2) [min, max].
            plain: run every kernel's plain PyTorch version (also on CUDA).
            train: the training forward (batch-statistics BatchNorm, which
                updates the running statistics; differentiable).
        Returns:
            train: {"depth": [d_1/8, d_1/4, d_1/2, d_full]}, each (B, h, w)
            f32;
            eval: {"depth": (B, H, W), "confidence": (B, H, W),
            "coverage_ok": () bool, always True — the port has no warp
            window contract}.
        """
        if train:
            if halo.current_ctx() is not None:
                raise ValueError("spatial sharding shards the eval forward "
                                 "only (the JAX package has no spatial "
                                 "training)")
            return self._train_forward(imgs, extrinsics, intrinsics,
                                       depth_range, plain)
        with torch.no_grad():
            return self._eval_forward(imgs, extrinsics, intrinsics,
                                      depth_range, plain)

    def _hypotheses(self, stage, depth_range, depth, prob, hypos):
        if self.hypo_impl == "atv" and depth is not None:
            # the band: the previous depth +- its posterior's expected
            # deviation sqrt(E[(hypo - depth)^2])
            with torch.no_grad():
                dev = torch.sqrt(torch.clamp(depth_regression(
                    prob, (hypos - depth[:, None]) ** 2), min=0.0))
                return atv_hypos(resize_bilinear_2x(depth), dev, depth_range,
                                 self.ndepths[stage])
        if self.curve_classes[stage] is None:
            return uniform_hypotheses(depth_range, self.ndepths[stage])
        return refined_hypotheses(depth, depth_range, prob, hypos,
                                  ndepths=self.ndepths[stage],
                                  curve_class=self.curve_classes[stage],
                                  prob_thresh=self.prob_threshs[stage])

    def _train_forward(self, imgs, extrinsics, intrinsics, depth_range,
                       plain):
        """JAX ``core.py:134-281`` with ``train=True``: one view-major
        backbone pass with per-view BatchNorm statistics; the hypotheses
        (fitting under no_grad) and the geometry carry no gradient."""
        b, v = imgs.shape[:2]
        nstages = len(self.ndepths)
        vstack = imgs.transpose(0, 1).reshape((v * b,) + imgs.shape[2:])
        fs = self._block(self.Backbone, vstack.to(self.dtype), plain=plain,
                         train=True, vgroups=v)
        intrinsics, extrinsics = intrinsics.float(), extrinsics.float()
        depths, depth, hypos, prob = [], None, None, None
        for stage in range(nstages):
            ref_proj, src_projs = geometry.projection_matrices(
                intrinsics, extrinsics, stage, num_stages=nstages + 1)
            # refined_hypotheses runs under no_grad
            hypos = self._hypotheses(stage, depth_range, depth, prob, hypos)
            feats = fs[stage].reshape((v, b) + fs[stage].shape[1:])
            cost = self._block(self.Homoaggre[stage], feats.transpose(0, 1),
                               ref_proj, src_projs, hypos, plain=plain,
                               train=True)
            prob = self._block(self.Regular[stage], cost.to(self.dtype),
                               plain=plain, train=True)
            depth = depth_regression(prob, hypos)
            depths.append(depth)
        depths.append(self._refine(imgs, depth, depth_range, plain, True))
        return {"depth": depths}

    def _block(self, module: nn.Module, *args, **kwargs):
        """``module(*args, **kwargs)`` in the training forward; under remat
        checkpointed, its recomputation with the block's BatchNorms
        marked ``recomputing``."""
        if not self.remat:
            return module(*args, **kwargs)
        return checkpoint(module, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _recomputing(module)),
                          **kwargs)

    def _refine(self, imgs, depth, depth_range, plain, train):
        extra = (imgs[:, 0],) if isinstance(self.Refine, RefineNet) else ()
        return self.Refine(*extra, depth, depth_range, dtype=self.dtype,
                           plain=plain, train=train)

    def _eval_forward(self, imgs, extrinsics, intrinsics, depth_range,
                      plain):
        b, v = imgs.shape[:2]
        nstages = len(self.ndepths)
        stacked = imgs.reshape((b * v,) + imgs.shape[2:]).to(self.dtype)
        fs = self.Backbone(stacked, plain=plain)    # coarsest first
        intrinsics, extrinsics = intrinsics.float(), extrinsics.float()

        depth = hypos = prob = None
        for stage in range(nstages):
            ref_proj, src_projs = geometry.projection_matrices(
                intrinsics, extrinsics, stage, num_stages=nstages + 1)
            hypos = self._hypotheses(stage, depth_range, depth, prob, hypos)
            feats = fs[stage].reshape((b, v) + fs[stage].shape[1:])
            kw = {"diffs": True} if self.Backbone.emit_diffs else {}
            cost = self.Homoaggre[stage](feats, ref_proj, src_projs, hypos,
                                         plain=plain, **kw)
            prob = self.Regular[stage](cost.to(self.dtype), plain=plain)
            depth = depth_regression(prob, hypos)

        depth = self._refine(imgs, depth, depth_range, plain, False)
        confidence = resize_nearest_2x(confidence_regression(prob))
        return {"depth": depth, "confidence": confidence,
                "coverage_ok": torch.ones((), dtype=torch.bool,
                                          device=depth.device)}


@contextlib.contextmanager
def _recomputing(module: nn.Module):
    """Mark every BatchNorm of ``module`` as recomputing while it runs."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False
