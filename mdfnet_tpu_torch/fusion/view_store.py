"""Bounded-memory per-view storage for the fusion pipelines (a copy of
``mdfnet_tpu/fusion/view_store.py``).

The reference fusion tools either load per-ref-view from disk
(tools/filter/dynamic_filter_gpu.py:39-58) or chunk their candidate sets
(tools/pcd/fusion.py:88-97); holding a whole Tanks & Temples scan in RAM
(e.g. Palace: 509 views x 2048x1056 — ~13 GB of f32 images alone) is not an
option. ViewStore keeps a small LRU of decoded views in RAM and spills
evicted MUTATED views to an npz directory, so iterative pipelines (the pcd
fusion's filter/zbuffer/average passes mutate depths and masks between
sweeps) stay exact with bounded resident memory: unmodified views reload
from their source files, modified ones from the bitwise-identical spill.

The pair graph gives each view ~10 neighbours with nearby ids, so a
maxsize of a few dozen serves almost every access from RAM on real scans.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np


class ViewStore:
    """Dict-of-arrays per view id, LRU-bounded with exact spill/reload.

    Args:
        load_fn: vid -> {name: ndarray} initial load from source files.
        maxsize: maximum number of views resident in RAM.
        spill_dir: directory for evicted mutated views (a temp dir is
            created and cleaned up by close() when omitted).
    """

    def __init__(self, load_fn: Callable[[int], Dict[str, np.ndarray]],
                 maxsize: int = 32, spill_dir: Optional[str] = None):
        self._load_fn = load_fn
        self._maxsize = max(1, int(maxsize))
        self._lru: "OrderedDict[int, Dict[str, np.ndarray]]" = OrderedDict()
        self._dirty: set = set()
        self._own_spill = spill_dir is None
        self._spill = spill_dir or tempfile.mkdtemp(prefix="viewstore_")
        self.peak_resident = 0

    def _spill_path(self, vid: int) -> str:
        return os.path.join(self._spill, f"{vid}.npz")

    def get(self, vid: int) -> Dict[str, np.ndarray]:
        """The view's arrays; do NOT mutate in place — use update()."""
        if vid in self._lru:
            self._lru.move_to_end(vid)
            return self._lru[vid]
        path = self._spill_path(vid)
        if os.path.exists(path):
            with np.load(path) as z:
                view = {k: z[k] for k in z.files}
        else:
            view = self._load_fn(vid)
        self._lru[vid] = view
        self._lru.move_to_end(vid)
        self._evict()
        self.peak_resident = max(self.peak_resident, len(self._lru))
        return view

    def update(self, vid: int, **arrays: np.ndarray) -> None:
        """Replace some of the view's arrays (persists across eviction)."""
        view = self.get(vid)
        view.update(arrays)
        self._dirty.add(vid)

    def _evict(self) -> None:
        while len(self._lru) > self._maxsize:
            vid, view = self._lru.popitem(last=False)
            if vid in self._dirty:
                np.savez(self._spill_path(vid), **view)

    def close(self) -> None:
        if self._own_spill and os.path.isdir(self._spill):
            shutil.rmtree(self._spill, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def pad_sources(arrays, max_s: int):
    """Pad per-src stacked arrays to ``max_s`` (replicating entry 0) and
    return (padded_list, valid (max_s,) bool). The JAX package pads to keep
    one jit specialisation per scan; the port's functions take any S, and
    keep the ``src_valid`` argument and its meaning: a padded source
    contributes nothing."""
    s = arrays[0].shape[0]
    valid = np.zeros((max_s,), bool)
    valid[:s] = True
    if s == max_s:
        return list(arrays), valid
    out = []
    for a in arrays:
        pad = np.repeat(a[:1], max_s - s, axis=0)
        out.append(np.concatenate([a, pad], axis=0))
    return out, valid
