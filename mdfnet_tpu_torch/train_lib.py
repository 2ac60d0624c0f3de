"""Training machinery of the port (twin of ``mdfnet_tpu/train_lib.py``):
the polynomial LR schedule, Adam, the train step and checkpoints.

Reference behaviour (reference train.py:11-68): Adam(1e-3) with torch's
defaults (b 0.9/0.999, eps 1e-8, the same update as the JAX package's
``optax.scale_by_adam``), the LR set per epoch to
``lr0 * (1 - (e-1)/max_epochs)^0.9``, the multi-scale smooth-L1 loss, a
checkpoint per epoch. Master weights, BatchNorm statistics, the loss and
Adam stay f32 whatever the convs' compute dtype.

With a process group, the step is data-parallel over ranks (JAX
``train_lib.py:66-147``, the ``shard_map`` step): each rank runs the
training forward on its shard, normalising with the shard's own BatchNorm
batch statistics; the loss's masked sums and counts are summed over the
ranks (``models/loss.py``), so each rank's backward gives its shard's share
of the global-batch gradient; the shares are summed over the ranks (one
all-reduce, in parameter order), which is the gradient JAX's pmean gives;
the running statistics are averaged over the ranks; then every rank takes
the same Adam step. The reduction is explicit rather than
``DistributedDataParallel``'s: DDP averages gradients (the loss would need
scaling by the world size) and broadcasts rank 0's buffers, where JAX
averages them. :func:`data_parallel_reference` is the same semantics in
one process, without collectives.

Checkpoints keep the reference ``.pth`` schema ``{'epoch', 'model'}`` and add
``'optimizer'`` (Adam's moments), so a port checkpoint resumes exactly; a
reference ``.pth`` (no optimizer state) warm-starts the weights only, like
the reference's resume. Both resume at the saved epoch + 1.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mdfnet_tpu_torch.models.loss import multi_scale_depth_loss
from mdfnet_tpu_torch.parallel.mesh import shard_batch
from mdfnet_tpu_torch.utils import tracing
from mdfnet_tpu_torch.utils.weights import load_checkpoint

_INPUTS = ("imgs", "extrinsics", "intrinsics", "depth_range")


def poly_lr(epoch: int, base_lr: float, max_epochs: int,
            factor: float) -> float:
    """lr0 * (1 - (epoch-1)/max_epochs)^factor — reference train.py:34."""
    return base_lr * (1.0 - (epoch - 1.0) / max_epochs) ** factor


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with torch's defaults over every parameter."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def batch_to_device(batch: Mapping, device) -> dict:
    """A loader batch (numpy arrays, ``ref_depths`` a dict of them) as
    tensors on ``device``; other entries (file names) are dropped."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {k: put(batch[k]) for k in _INPUTS}
    out["ref_depths"] = {k: put(v) for k, v in batch["ref_depths"].items()}
    return out


def loss_and_grads(model: nn.Module, batch: Mapping, *, plain: bool = False,
                   group=None) -> torch.Tensor:
    """The training forward (which updates the BatchNorm running
    statistics), the loss, and its backward into every parameter's
    ``.grad`` (accumulated: zero them first). Returns the detached loss.
    With a process group, ``batch`` is the rank's shard, the loss the
    global batch's and the gradients the shard's share of its gradient."""
    out = model(*(batch[k] for k in _INPUTS), plain=plain, train=True)
    with tracing.span("loss"):
        loss = multi_scale_depth_loss(out["depth"], batch["ref_depths"],
                                      batch["depth_range"], group=group)
    with tracing.span("backward"):
        loss.backward()
    return loss.detach()


def _running_stats(model: nn.Module) -> list[torch.Tensor]:
    return [b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def _all_reduce(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over the ranks in place: one all-reduce of their
    concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def reduce_gradients(model: nn.Module, group) -> None:
    """Sum every parameter's gradient over the ranks."""
    _all_reduce([p.grad for p in model.parameters() if p.grad is not None],
                group)


def average_running_stats(model: nn.Module, group) -> None:
    """Average every BatchNorm's running mean and variance over the ranks
    (JAX pmeans its ``batch_stats``); the update counts agree already."""
    stats = _running_stats(model)
    _all_reduce(stats, group)
    for t in stats:
        t.div_(dist.get_world_size(group))


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               batch: Mapping, *, plain: bool = False,
               group=None) -> torch.Tensor:
    """One step: forward, loss, backward, Adam. Returns the loss, computed
    with the parameters before the update. With a process group, ``batch``
    is the rank's shard; the gradients are summed and the running
    statistics averaged over the ranks before Adam."""
    with tracing.span("train_step"):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_and_grads(model, batch, plain=plain, group=group)
        if group is not None:
            with tracing.span("reduce"):
                reduce_gradients(model, group)
                average_running_stats(model, group)
        with tracing.span("optimizer"):
            optimizer.step()
    return loss


def data_parallel_reference(model: nn.Module, batch: Mapping, world: int, *,
                            plain: bool = False) -> torch.Tensor:
    """What ``world`` ranks compute in :func:`train_step` before Adam, in
    one process without collectives: each shard's training forward in
    turn, from the same running statistics and with its own batch
    statistics; the gradient of the global-batch loss of those forwards
    into ``.grad`` (accumulated: zero them first); the shards' running
    statistics averaged. Returns the detached loss."""
    buffers = list(model.buffers())
    start = [t.clone() for t in buffers]
    depths, ends = [], []
    for rank in range(world):
        for t, t0 in zip(buffers, start):
            t.copy_(t0)
        shard = shard_batch(batch, rank, world)
        depths.append(model(*(shard[k] for k in _INPUTS), plain=plain,
                            train=True)["depth"])
        ends.append([t.clone() for t in buffers])
    loss = multi_scale_depth_loss([torch.cat(d) for d in zip(*depths)],
                                  batch["ref_depths"], batch["depth_range"])
    loss.backward()
    running = {id(t) for t in _running_stats(model)}
    with torch.no_grad():
        for i, t in enumerate(buffers):
            if id(t) in running:
                t.copy_(sum(e[i] for e in ends) / world)
    return loss.detach()


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, epoch: int) -> None:
    """The reference ``.pth`` schema plus the optimizer's state."""
    torch.save({"epoch": int(epoch), "model": model.state_dict(),
                "optimizer": optimizer.state_dict()}, path)


def resume(path: str, model: nn.Module,
           optimizer: torch.optim.Optimizer) -> int:
    """Load a checkpoint into ``model`` (strictly) and, when it holds one,
    the optimizer's state; returns the epoch to start at (saved + 1)."""
    epoch = load_checkpoint(model, path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    return epoch + 1
