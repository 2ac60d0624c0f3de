"""Depth and confidence regression (port of ``mdfnet_tpu/ops/regress.py``)."""
from __future__ import annotations

import torch

from mdfnet_tpu_torch.ops.sample import resize_bicubic_2x


def depth_regression(prob_volume: torch.Tensor,
                     depth_hypos: torch.Tensor) -> torch.Tensor:
    """Soft-argmax depth. prob_volume (B, D, H, W); depth_hypos (B, D, H, W)
    or (B, D, 1, 1). Returns (B, H, W)."""
    return torch.sum(prob_volume * depth_hypos, dim=1)


_WINDOW = 4   # bins summed around the regressed index


def confidence_regression(prob_volume: torch.Tensor,
                          last_confidence: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Posterior mass of the 4 bins [i-1, i+2] around the floored
    soft-argmax index i (reference net/unit/regress.py:9-18: ``n *
    avg_pool3d`` over a D-padded (1 front, 2 back) volume).

    Args:
        prob_volume: (B, D, H, W).
        last_confidence: (B, H/2, W/2) or None: the previous stage's
            confidence, blended in as ``0.8 * bicubic_2x(last) + 0.2 *
            conf`` (the reference's optional EMA, regress.py:20-23, which
            its CoreNet does not use).
    Returns:
        (B, H, W) confidence.
    """
    b, d, h, w = prob_volume.shape
    padded = torch.cat([prob_volume.new_zeros(b, 1, h, w), prob_volume,
                        prob_volume.new_zeros(b, 2, h, w)], dim=1)
    window_sum = padded[:, :d]
    for k in range(1, _WINDOW):
        window_sum = window_sum + padded[:, k:k + d]
    index = torch.arange(d, dtype=prob_volume.dtype,
                         device=prob_volume.device).reshape(1, d, 1, 1)
    # float -> int truncates, i.e. floors the non-negative expectation
    depth_index = torch.sum(prob_volume * index, dim=1).to(torch.int64)
    depth_index = depth_index.clamp(0, d - 1)
    conf = torch.gather(window_sum, 1, depth_index[:, None])[:, 0]
    if last_confidence is not None:
        conf = 0.8 * resize_bicubic_2x(last_confidence) + 0.2 * conf
    return conf
