"""Training machinery of the port (twin of ``mdfnet_tpu/train_lib.py``):
the polynomial LR schedule, Adam, the train step and checkpoints.

Reference behaviour (reference train.py:11-68): Adam(1e-3) with torch's
defaults (b 0.9/0.999, eps 1e-8, the same update as the JAX package's
``optax.scale_by_adam``), the LR set per epoch to
``lr0 * (1 - (e-1)/max_epochs)^0.9``, the multi-scale smooth-L1 loss, a
checkpoint per epoch. Master weights, BatchNorm statistics, the loss and
Adam stay f32 whatever the convs' compute dtype.

Checkpoints keep the reference ``.pth`` schema ``{'epoch', 'model'}`` and add
``'optimizer'`` (Adam's moments), so a port checkpoint resumes exactly; a
reference ``.pth`` (no optimizer state) warm-starts the weights only, like
the reference's resume. Both resume at the saved epoch + 1.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from mdfnet_tpu_torch.models.loss import multi_scale_depth_loss
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


def loss_and_grads(model: nn.Module, batch: Mapping, *,
                   plain: bool = False) -> torch.Tensor:
    """The training forward (which updates the BatchNorm running
    statistics), the loss, and its backward into every parameter's
    ``.grad`` (accumulated: zero them first). Returns the detached loss."""
    out = model(*(batch[k] for k in _INPUTS), plain=plain, train=True)
    loss = multi_scale_depth_loss(out["depth"], batch["ref_depths"],
                                  batch["depth_range"])
    loss.backward()
    return loss.detach()


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               batch: Mapping, *, plain: bool = False) -> torch.Tensor:
    """One step: forward, loss, backward, Adam. Returns the loss, computed
    with the parameters before the update."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_and_grads(model, batch, plain=plain)
    optimizer.step()
    return loss


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
