"""Depth-map -> point-cloud fusion backends of the port (counterparts of
``mdfnet_tpu/fusion``), batched PyTorch on the card or the CPU:

- dynamic_filter: dynamic multi-view consistency filter (fusion A — the main
  method for Tanks & Temples, reference tools/filter/).
- consistency_vote: fusibile-style per-pixel consistency vote (fusion B,
  reference tools/gipuma/ + tools/fusibile/ CUDA binary).
- pcd_fusion: visibility-based fusion with occlusion-aware z-buffer election
  and small-segment removal (fusion C, reference tools/pcd/); its two
  sequential cores run in ``native/fusion_core.cpp`` on the host.
"""

from mdfnet_tpu_torch.fusion.dynamic_filter import (
    fuse_scan, reproject_depth, geometric_consistency)
from mdfnet_tpu_torch.fusion.ply import write_ply, read_ply
