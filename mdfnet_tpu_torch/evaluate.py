"""Evaluation loop: depth + confidence inference, PFM/PNG outputs (port of
``mdfnet_tpu/evaluate.py``, reference eval.py:10-50).

Writes ``depth_est/<ref>.pfm``, ``depth_est/<ref>.png`` and
``confidence/<ref>.pfm`` per view through ``data/formats.py``, in the
reference's directory schema, so the fusion backends are drop-in. A writer
thread stores batch i's files while the card runs batch i + 1.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict

import numpy as np
import torch

from mdfnet_tpu_torch.data.formats import (ensure_dir, write_depth_png,
                                           write_pfm)
from mdfnet_tpu_torch.data.pipeline import BatchLoader

log = logging.getLogger("mdfnet_tpu_torch.eval")


def _write_views(output_dir: str, filename: str, depth: np.ndarray,
                 conf: np.ndarray) -> None:
    depth_path = os.path.join(output_dir, filename.format("depth_est", ".pfm"))
    conf_path = os.path.join(output_dir, filename.format("confidence", ".pfm"))
    ensure_dir(os.path.dirname(depth_path))
    ensure_dir(os.path.dirname(conf_path))
    write_pfm(depth_path, depth)
    write_depth_png(os.path.join(output_dir,
                                 filename.format("depth_est", ".png")), depth)
    write_pfm(conf_path, conf)


def run_eval(model: torch.nn.Module, dataset,
             output_dir: str) -> Dict[str, float]:
    """Evaluate every item (batch 1, the DTU eval setting), write its files,
    return timing stats.

    - ``first_map_sec``: the first batch, inputs to depth on the host
      (includes the kernels' build and first launches);
    - ``device_sec_per_view``: later batches, host clock around the
      forward with its input and output copies;
    - ``wall_sec_per_view``: later batches end to end, file writes
      included (they overlap the next forward on the writer thread);
    - ``device_views_per_sec`` and the JAX package's aliases
      ``sec_per_view`` (= ``device_sec_per_view``) and ``views_per_sec``;
    - ``n_coverage_fallbacks`` (0) and ``coverage_fallback_rate`` (0.0):
      the port's warps have no window contract, so no item is re-run.
    """
    device = next(model.parameters()).device
    loader = BatchLoader(dataset, 1, shuffle=False, drop_last=False,
                         num_workers=2)
    write_q: "queue.Queue" = queue.Queue(maxsize=4)
    write_err: list = []

    def writer():
        while (item := write_q.get()) is not None:
            try:
                _write_views(output_dir, *item)
            except Exception as e:  # noqa: BLE001 — keep draining the
                write_err.append(e)  # queue; re-raised after the loop

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    n_views, device_time, first_map, wall_start = 0, 0.0, 0.0, None
    try:
        for i, batch in enumerate(loader):
            start = time.perf_counter()
            args = [torch.from_numpy(np.asarray(batch[k])).to(device)
                    for k in ("imgs", "extrinsics", "intrinsics",
                              "depth_range")]
            out = model(*args)
            depth = out["depth"].float().cpu().numpy()
            conf = out["confidence"].float().cpu().numpy()
            elapsed = time.perf_counter() - start
            if i == 0:
                first_map = elapsed
                wall_start = time.perf_counter()
            else:
                device_time += elapsed
                n_views += depth.shape[0]
            for b, filename in enumerate(batch["filename"]):
                write_q.put((filename, depth[b], conf[b]))
            if i % 10 == 0:
                log.info("eval %d/%d  %.3fs/batch", i + 1, len(loader),
                         elapsed)
    finally:
        write_q.put(None)
        wt.join()
    if write_err:
        raise write_err[0]
    wall_time = time.perf_counter() - wall_start if wall_start else 0.0
    sec_per_view = device_time / max(n_views, 1)
    views_per_sec = n_views / device_time if device_time else 0.0
    return {"first_map_sec": first_map,
            "device_sec_per_view": sec_per_view,
            "device_views_per_sec": views_per_sec,
            "wall_sec_per_view": wall_time / max(n_views, 1),
            "sec_per_view": sec_per_view,
            "views_per_sec": views_per_sec,
            "n_views": n_views,
            "n_coverage_fallbacks": 0,
            "coverage_fallback_rate": 0.0}
