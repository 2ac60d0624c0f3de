"""Evaluation loop: depth + confidence inference, PFM/PNG outputs (port of
``mdfnet_tpu/evaluate.py``, reference eval.py:10-50).

Writes ``depth_est/<ref>.pfm``, ``depth_est/<ref>.png`` and
``confidence/<ref>.pfm`` per view through ``data/formats.py``, in the
reference's directory schema, so the fusion backends are drop-in. A writer
thread stores batch i's files while the card runs batch i + 1.

``spatial=N`` (JAX ``evaluate.py:25-40``) runs the forward with the image
height sharded over N ranks (``parallel/spatial.py``): the kernels are built
once, then ``spawn_ranks`` starts N processes meeting over TCP on
localhost, a card a rank over NCCL where there are N cards, else over gloo
(on one card, or on the CPU). Every rank loads the checkpoint and reads
every item; rank 0 alone writes the files and returns the stats.
"""
from __future__ import annotations

import json
import logging
import os
import queue
import tempfile
import threading
import time
from typing import Dict

import numpy as np
import torch

from mdfnet_tpu_torch.data.formats import (ensure_dir, write_depth_png,
                                           write_pfm)
from mdfnet_tpu_torch.data.pipeline import BatchLoader
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.parallel import (default_backend, init_data_parallel,
                                       local_init_method, rank_device,
                                       spawn_ranks)
from mdfnet_tpu_torch.parallel.spatial import (band_rows, check_model,
                                               spatial_eval_forward)
from mdfnet_tpu_torch.utils.weights import load_checkpoint, save_checkpoint

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


def run_eval(model: torch.nn.Module, dataset, output_dir: str, *,
             spatial: int = 1, checkpoint: str | None = None,
             timeout: float | None = None) -> Dict[str, float]:
    """Evaluate every item (batch 1, the DTU eval setting), write its files,
    return timing stats.

    ``spatial`` > 1: over that many ranks, H-sharded (the module's
    docstring); each rank builds ``model.config`` on its device and loads
    ``checkpoint`` (default: ``model``'s weights, saved for them); past
    ``timeout`` seconds the ranks are killed and this raises. Units that
    sharding does not compute exactly, and heights that do not divide
    ``spatial`` x 32, raise ``ValueError`` first.

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
    if spatial > 1:
        return _run_spatial(model, dataset, output_dir, spatial, checkpoint,
                            timeout)
    return _eval_loop(model, dataset, output_dir)


def _run_spatial(model, dataset, output_dir, n, checkpoint, timeout):
    check_model(model)
    band_rows(np.asarray(dataset[0]["imgs"]).shape[1], n, 0)
    device_type = next(model.parameters()).device.type
    if device_type == "cuda":
        # once, here: the ranks would each compile the kernels
        from mdfnet_tpu_torch.ops.cuda import build
        build.build()
    with tempfile.TemporaryDirectory() as tmp:
        if checkpoint is None:
            checkpoint = os.path.join(tmp, "weights.pth")
            save_checkpoint(model, checkpoint)
        stats_path = os.path.join(tmp, "stats.json")
        spawn_ranks(_spatial_rank, n, (
            default_backend(n, device_type), local_init_method(),
            device_type, model.config, checkpoint, dataset, output_dir,
            stats_path, timeout), timeout=timeout)
        with open(stats_path) as f:
            return json.load(f)


def _spatial_rank(rank: int, world: int, backend: str, init_method: str,
                  device_type: str, config, checkpoint: str, dataset,
                  output_dir: str, stats_path: str,
                  timeout: float | None) -> None:
    """One rank of ``run_eval(..., spatial=world)``."""
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s-%(levelname)s-rank {rank}: "
                               f"%(message)s")
    device = rank_device(rank, device_type)
    group = init_data_parallel(rank, world, backend, init_method, timeout)
    try:
        model = build_model(config, device=device)
        load_checkpoint(model, checkpoint)
        stats = _eval_loop(model, dataset, output_dir, group=group)
        if rank == 0:
            with open(stats_path, "w") as f:
                json.dump(stats, f)
    finally:
        torch.distributed.destroy_process_group()


def _eval_loop(model: torch.nn.Module, dataset, output_dir: str,
               group=None) -> Dict[str, float]:
    """The loop of one process: the whole forward (``group`` None), or this
    rank's band of it, rank 0 writing."""
    writes = group is None or torch.distributed.get_rank(group) == 0
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
            args = [torch.from_numpy(np.asarray(batch[k]))
                    for k in ("imgs", "extrinsics", "intrinsics",
                              "depth_range")]
            # a rank moves its band of the images alone to its device
            out = (model(*(a.to(device) for a in args)) if group is None
                   else spatial_eval_forward(model, *args, group))
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
                if writes:
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
