"""Multi-scale masked smooth-L1 depth loss (port of
``mdfnet_tpu/models/loss.py``, reference net/loss.py:6-27).

For each of the 4 output scales: smooth-L1 (beta 1) between the predicted
and the ground-truth depth, averaged over the pixels whose ground truth
exceeds the item's depth minimum; the 4 means are summed. Like the JAX
version, the mean divides by max(count, 1): an empty mask gives 0 where the
reference's boolean indexing gives NaN.

With a process group (data-parallel training, ``parallel/mesh.py``), the
masked sums and counts are summed over the ranks before the division (JAX
``loss.py:45-50``), so every rank holds the global batch's masked mean. The
sum enters with the gradient of the rank's own sum: each rank's backward
gives its shard's share of the global gradient, and the ranks' shares
summed (``train_lib.reduce_gradients``) are the global gradient.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.distributed as dist


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def multi_scale_depth_loss(depths: Sequence[torch.Tensor],
                           gt_pyramid: Mapping[str, torch.Tensor],
                           depth_range: torch.Tensor,
                           group=None) -> torch.Tensor:
    """
    Args:
        depths: predicted depths coarse to fine, [d_1/8, d_1/4, d_1/2,
            d_full], each (B, h, w).
        gt_pyramid: {"3": 1/8 GT, "2": 1/4, "1": 1/2, "0": full}, each
            (B, h, w).
        depth_range: (B, 2).
        group: a process group over which the batch is sharded, or None.
    Returns:
        The f32 scalar loss (the global batch's with a group).
    """
    dmin = depth_range[:, 0].float().reshape(-1, 1, 1)
    sums, counts = [], []
    for depth, key in zip(depths, ("3", "2", "1", "0")):
        gt = gt_pyramid[key].float()
        mask = (gt > dmin).float()
        sums.append((smooth_l1(depth.float(), gt) * mask).sum())
        counts.append(mask.sum())
    if group is not None:
        total = torch.stack(sums + counts).detach()
        dist.all_reduce(total, group=group)
        # the global sum's value, the rank's own sum's gradient
        sums = [s - s.detach() + t for s, t in zip(sums, total)]
        counts = total[len(sums):]
    total = 0.0
    for s, c in zip(sums, counts):
        total = total + s / c.clamp(min=1.0)
    return total
