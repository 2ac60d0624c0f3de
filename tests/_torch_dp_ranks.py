"""Rank programs of the data-parallel tests (tests/test_torch_parallel*.py),
started by ``mdfnet_tpu_torch.parallel.spawn_ranks`` on the CPU over gloo.
This module imports nothing of JAX: a spawned rank imports it by name.

Each rank reads its inputs from a ``torch.save`` file and writes what it
computed to ``<out>/rank<r>.pt``; the digest of a replica and the skipped
gradient reduction (the fault) are chip_smoke.py's. Collectives time out after
``COLLECTIVE_TIMEOUT`` seconds, so a rank waiting for a dead peer fails
rather than hangs.
"""
import torch

from chip_smoke import _skip_gradient_reduction, state_digest
from mdfnet_tpu_torch import train_lib
from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.models.loss import multi_scale_depth_loss
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.parallel import init_data_parallel, shard_batch

COLLECTIVE_TIMEOUT = 60.0


def _join(rank, world, init_method):
    torch.set_num_threads(1)
    return init_data_parallel(rank, world, "gloo", init_method,
                              timeout=COLLECTIVE_TIMEOUT)


def loss_rank(rank, world, init_method, inputs, out):
    """The group loss of the rank's shard of (depths, gt, depth_range)."""
    group = _join(rank, world, init_method)
    try:
        data = torch.load(inputs)
        n = len(data["depth_range"]) // world
        part = slice(rank * n, (rank + 1) * n)
        loss = multi_scale_depth_loss(
            [d[part] for d in data["depths"]],
            {k: v[part] for k, v in data["ref_depths"].items()},
            data["depth_range"][part], group=group)
        torch.save(float(loss), f"{out}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def step_rank(rank, world, init_method, inputs, out):
    """``steps`` train steps (train_lib.train_step with the group) on the
    rank's shard of one global batch, from a state_dict; saves the first
    step's loss, reduced gradients and running statistics, and each step's
    digest. ``fault``: the rank that skips the gradient reduction."""
    group = _join(rank, world, init_method)
    try:
        setup = torch.load(inputs)
        if setup.get("fault") == rank:
            train_lib.reduce_gradients = _skip_gradient_reduction
        model = build_model(ModelConfig(**setup["config"]), device="cpu")
        model.load_state_dict(setup["state_dict"], strict=True)
        model.requires_grad_(True)
        optimizer = train_lib.make_optimizer(model, setup["lr"])
        shard = shard_batch(setup["batch"], rank, world)
        result = {"digests": []}
        for step in range(setup["steps"]):
            loss = train_lib.train_step(model, optimizer, shard, group=group)
            if step == 0:
                result["loss"] = float(loss)
                result["grads"] = {n: p.grad.clone()
                                   for n, p in model.named_parameters()}
                result["buffers"] = {n: b.clone()
                                     for n, b in model.named_buffers()}
            result["digests"].append(state_digest(model, optimizer))
        torch.save(result, f"{out}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def failing_rank(rank, world):
    """Rank 1 fails at once; rank 0 would wait on it forever."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    import time
    time.sleep(600)


def sleeping_rank(rank, world):
    """A rank that hangs, as one waiting in a collective would."""
    import time
    time.sleep(600)
