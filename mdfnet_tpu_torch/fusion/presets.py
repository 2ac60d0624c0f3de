"""Per-scene fusion presets mirroring the reference's tuned values (a copy
of ``mdfnet_tpu/fusion/presets.py``).

The reference hand-tunes the consistency-vote fusion per Tanks & Temples
scene (reference tools/gipuma/conf.py:34-68: prob_threshold, check_views,
disp_threshold); DTU uses one setting for all scans (conf.py:34-36). These
tables feed cli/fuse.py's ``vote`` backend so published-benchmark runs use
the same operating points.
"""
from __future__ import annotations

from typing import Dict

# DTU: uniform across the 22 eval scans (reference gipuma/conf.py:34-36)
DTU_VOTE = {"prob_thresh": 0.6, "num_consistent": 3, "disp_thresh": 0.25}

TANKS_INTERMEDIATE_VOTE: Dict[str, dict] = {
    "Family":     {"prob_thresh": 0.8, "num_consistent": 4, "disp_thresh": 0.25},
    "Francis":    {"prob_thresh": 0.6, "num_consistent": 7, "disp_thresh": 0.2},
    "Horse":      {"prob_thresh": 0.6, "num_consistent": 4, "disp_thresh": 0.25},
    "Lighthouse": {"prob_thresh": 0.6, "num_consistent": 5, "disp_thresh": 0.3},
    "M60":        {"prob_thresh": 0.6, "num_consistent": 4, "disp_thresh": 0.2},
    "Panther":    {"prob_thresh": 0.8, "num_consistent": 4, "disp_thresh": 0.2},
    "Playground": {"prob_thresh": 0.8, "num_consistent": 5, "disp_thresh": 0.25},
    "Train":      {"prob_thresh": 0.8, "num_consistent": 5, "disp_thresh": 0.25},
}

TANKS_ADVANCED_VOTE: Dict[str, dict] = {
    "Auditorium": {"prob_thresh": 0.8, "num_consistent": 3, "disp_thresh": 0.25},
    "Ballroom":   {"prob_thresh": 0.8, "num_consistent": 5, "disp_thresh": 0.25},
    "Courtroom":  {"prob_thresh": 0.8, "num_consistent": 5, "disp_thresh": 0.25},
    "Museum":     {"prob_thresh": 0.8, "num_consistent": 5, "disp_thresh": 0.25},
    "Palace":     {"prob_thresh": 0.8, "num_consistent": 5, "disp_thresh": 0.25},
    "Temple":     {"prob_thresh": 0.8, "num_consistent": 4, "disp_thresh": 0.15},
}


def vote_preset(dataset: str, scene: str) -> dict:
    """Fusion-B operating point for a scene ('dtu', 'intermediate',
    'advanced')."""
    if dataset == "dtu":
        return dict(DTU_VOTE)
    table = (TANKS_INTERMEDIATE_VOTE if dataset == "intermediate"
             else TANKS_ADVANCED_VOTE)
    return dict(table.get(scene, DTU_VOTE))
