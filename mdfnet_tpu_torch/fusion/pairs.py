"""Pair-file resolution shared by the fusion backends (a copy of
``mdfnet_tpu/fusion/pairs.py``).

DTU eval keeps one pair.txt at the dataset root while Tanks keeps one per
scene (the reference tools disagree the same way: dynamic_filter_gpu.py:35
expects scan-local, load/dtueval.py:20 root-level) — accept both.
"""
from __future__ import annotations

import os


def _find_pair_file(scan_dir: str) -> str:
    local = os.path.join(scan_dir, "pair.txt")
    if os.path.exists(local):
        return local
    parent = os.path.join(os.path.dirname(scan_dir.rstrip("/")), "pair.txt")
    if os.path.exists(parent):
        return parent
    raise FileNotFoundError(f"no pair.txt in {scan_dir} or its parent")
