"""Plane-sweep homography warps (port of ``mdfnet_tpu/ops/warp.py`` and of
``homography_warp_pallas``, ``mdfnet_tpu/ops/pallas/warp_kernel.py:266``).

``homography_warp`` (gather) is the plain version behind the fused aggregate
kernel (``ops/cuda/aggregate_kernel.py``); ``homography_warp_train`` is the
differentiable warp of the training step, forward on the sample kernel (K6),
backward on the splat kernel (K7). Coordinates are f32 whatever the feature
type, in the reference's sampling convention
(:func:`mdfnet_tpu_torch.geometry.reference_grid_coords`).
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops.cuda.splat_kernel import splat_2d
from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d
from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d


def homography_warp(src_feat: torch.Tensor, src_proj: torch.Tensor,
                    ref_proj: torch.Tensor, depth_hypos: torch.Tensor, *,
                    height: int | None = None, row0: int = 0
                    ) -> torch.Tensor:
    """Warp (B, Hs, W, C) source features onto the ref plane sweep.

    Args:
        src_proj, ref_proj: (B, 4, 4).
        depth_hypos: (B, D, H, W) or (B, D, 1, 1).
        height: the reference grid's rows H (default Hs), from the
            reference image's row ``row0`` (a band of it under spatial
            sharding, where the sources are all-gathered to full height).
    Returns:
        (B, D, H, W, C) warped volume.
    """
    b, hs, w, c = src_feat.shape
    h = hs if height is None else height
    d = depth_hypos.shape[1]
    x_src, y_src = geometry.sweep_coordinates(src_proj, ref_proj,
                                              depth_hypos, h, w, row0)
    x_eff, y_eff = geometry.reference_grid_coords(x_src, y_src, hs, w)
    warped = bilinear_sample_2d(src_feat, x_eff, y_eff)    # (B, D, H*W, C)
    return warped.reshape(b, d, h, w, c)


class _Sample(torch.autograd.Function):
    """K6 forward, K7 backward; the coordinates carry no gradient."""

    @staticmethod
    def forward(ctx, image, x, y, plain):
        ctx.save_for_backward(x, y)
        ctx.extent, ctx.plain = image.shape[1:3], plain
        return sample_2d(image, x, y, plain=plain)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        d_img = splat_2d(g.contiguous(), x, y, *ctx.extent, plain=ctx.plain)
        return d_img.to(g.dtype), None, None, None


def homography_warp_train(src_feats: torch.Tensor, src_projs: torch.Tensor,
                          ref_proj: torch.Tensor, depth_hypos: torch.Tensor,
                          *, plain: bool = False) -> torch.Tensor:
    """Warp every source view onto the ref plane sweep, differentiably in
    the features: one sample launch for all views, one splat launch for
    their gradients.

    The coordinates are computed without gradient, as the JAX warp stops
    them (``warp_kernel.py:254-255``): no gradient reaches the projections
    or the hypotheses.

    Args:
        src_feats: (B, S, H, W, C) source features.
        src_projs: (B, S, 4, 4); ref_proj: (B, 4, 4).
        depth_hypos: (B, D, H, W) or (B, D, 1, 1).
    Returns:
        (B, S, D, H, W, C) in the features' dtype.
    """
    b, s, h, w, c = src_feats.shape
    x, y = sweep_sample_coords(src_projs, ref_proj, depth_hypos, h, w)
    images = src_feats.reshape(b * s, h, w, c).contiguous()
    warped = _Sample.apply(images, x, y, plain)          # (B*S, D, H, W, C)
    return warped.reshape((b, s) + warped.shape[1:])


@torch.no_grad()
def sweep_sample_coords(src_projs: torch.Tensor, ref_proj: torch.Tensor,
                        depth_hypos: torch.Tensor, height: int, width: int,
                        *, src_height: int | None = None, row0: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 pixel coordinates at which every ref pixel, lifted to every
    plane, samples every source: (x, y), each (B*S, D, H, W), source-major
    within each batch item. src_projs (B, S, 4, 4); ref_proj (B, 4, 4);
    depth_hypos (B, D, H, W) or (B, D, 1, 1). The reference grid is H =
    ``height`` rows from the reference image's row ``row0``; the sources
    are ``src_height`` (default H) rows high: under spatial sharding a band
    samples the all-gathered full-height sources."""
    b, s = src_projs.shape[:2]
    d = depth_hypos.shape[1]
    hypos = depth_hypos.float()[:, None].expand((b, s) + depth_hypos.shape[1:])
    x, y = geometry.sweep_coordinates(
        src_projs.reshape(b * s, 4, 4),
        ref_proj[:, None].expand(b, s, 4, 4).reshape(b * s, 4, 4),
        hypos.reshape((b * s,) + hypos.shape[2:]), height, width, row0)
    x, y = geometry.reference_grid_coords(
        x, y, height if src_height is None else src_height, width)
    return (x.reshape(b * s, d, height, width).contiguous(),
            y.reshape(b * s, d, height, width).contiguous())
