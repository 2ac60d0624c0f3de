"""Data parallelism over ranks: one process a rank, a full replica of the
model on each (counterpart of ``mdfnet_tpu/parallel/mesh.py`` and of the
data extent rule of ``mdfnet_tpu/train.py:42-52``).

The global batch is split along axis 0 into contiguous shards: rank r
takes items [r B/n, (r+1) B/n), where JAX's ``NamedSharding(mesh,
P("data"))`` places them. Every rank reads the same seeded ``BatchLoader``
and keeps its shard (no ``DistributedSampler``), so a run over n ranks sees
the global batches that one process sees. The step that reduces over the
ranks is ``train_lib.train_step`` with a process group.

Batch normalisation follows JAX's ``shard_map`` step, which JAX's
multi-device train CLI runs: each shard normalises with its own batch
statistics and the updated running statistics are averaged over the ranks
(not the globally synced statistics of JAX's GSPMD path).

Rank r runs on ``cuda:(r % device_count)``: with a card a rank the ranks
talk over NCCL; ranks that share a card (NCCL refuses two ranks on one
device) or run on the CPU use gloo, which takes CUDA tensors too.
"""
from __future__ import annotations

import datetime
import faulthandler
import multiprocessing
import multiprocessing.connection
import os
import signal
import socket
import time
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from mdfnet_tpu_torch.config import MeshConfig


def data_world(batch_size: int, n_devices: int) -> int:
    """The largest divisor of the batch that is at most the device count
    (JAX ``train.py:47-52``; DataParallel likewise idles surplus GPUs when
    the batch is smaller)."""
    return max(k for k in range(1, min(max(n_devices, 1), batch_size) + 1)
               if batch_size % k == 0)


def data_extent(mesh: MeshConfig, batch_size: int, n_devices: int) -> int:
    """The number of data-parallel ranks for ``mesh``: ``data_parallel`` =
    -1 takes :func:`data_world`; any other value must divide the batch.
    Training has no spatial sharding (nor has the JAX package's):
    ``spatial_parallel != 1`` raises; the eval forward shards H with
    ``parallel/spatial.py`` (``cli.eval --spatial N``)."""
    if mesh.spatial_parallel != 1:
        raise NotImplementedError(
            "spatial sharding (MeshConfig.spatial_parallel != 1) shards the "
            "eval forward only (cli.eval --spatial N), not training")
    if mesh.data_parallel == -1:
        return data_world(batch_size, n_devices)
    if mesh.data_parallel < 1 or batch_size % mesh.data_parallel:
        raise ValueError(f"{mesh.data_parallel} ranks do not divide a "
                         f"batch of {batch_size}")
    return mesh.data_parallel


def default_backend(world: int, device_type: str) -> str:
    """NCCL where each rank has a card of its own, else gloo."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """``cuda:(rank % device_count)`` (made the current card), or the
    CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def local_init_method() -> str:
    """``tcp://localhost:<port>`` on a port that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def init_data_parallel(rank: int, world: int, backend: str,
                       init_method: str, timeout: float | None = None):
    """Join the process group of ``world`` ranks as ``rank``
    (``init_method``: ``tcp://localhost:<port>`` or ``file://<path>``);
    ``timeout`` seconds bound every collective. Returns the group."""
    kwargs = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kwargs)
    return dist.group.WORLD


def shard_batch(batch: Mapping, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous share of each entry of a global batch
    (arrays, tensors or lists; a dict entry, such as ``ref_depths``, entry
    by entry)."""
    b = len(batch["imgs"])
    if b % world:
        raise ValueError(f"{world} ranks do not divide a batch of {b}")
    n = b // world

    def take(v):
        if isinstance(v, Mapping):
            return {k: take(x) for k, x in v.items()}
        return v[rank * n:(rank + 1) * n]
    return {k: take(v) for k, v in batch.items()}


def _rank_main(fn: Callable, rank: int, world: int, args: tuple) -> None:
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    fn(rank, world, *args)


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                timeout: float | None = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` processes started with
    ``spawn`` (CUDA cannot fork) and wait for them all. ``fn`` must be
    importable by name. If a rank fails, or ``timeout`` seconds pass, the
    ranks still running are killed and this raises: a rank that waits in a
    collective for a dead one never hangs the caller. A rank prints its
    Python stacks on SIGUSR1, as it is about to be killed on a timeout."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} of {world} exited "
                                   f"with code {bad[0][1]}")
            if all(c == 0 for c in codes):
                return
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                for p in procs:
                    if p.is_alive():
                        os.kill(p.pid, signal.SIGUSR1)
                time.sleep(2.0)
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s: {codes}")
            # the ranks running at the snapshot: a rank that exits after
            # it leaves its sentinel ready, so the wait cannot miss it
            multiprocessing.connection.wait(
                [p.sentinel for p, c in zip(procs, codes) if c is None],
                timeout=left)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
