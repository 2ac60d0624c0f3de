"""Weights in the reference ``state_dict`` schema.

The port's module names copy the reference's, so a reference ``.pth`` and a
JAX-exported variable tree (through ``mdfnet_tpu.utils.pth_import``) load
with ``load_state_dict(strict=True)`` and no converter.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mdfnet_tpu.utils.pth_import import variables_to_state_dict


def state_dict_from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """A JAX model's ``{'params', 'batch_stats'}`` tree (numpy or jax arrays)
    as a torch state_dict in the reference schema, for
    ``model.load_state_dict(..., strict=True)``."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in variables_to_state_dict(variables).items()}


def load_checkpoint(model: nn.Module, path: str) -> int:
    """Load a reference-schema ``.pth`` ({'epoch', 'model'}, reference
    train.py:59-68) strictly; returns the epoch (-1 if absent)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model"] if "model" in ckpt else ckpt
    # reference checkpoints may carry prob_thresh entries, which hold no
    # weights (pth_import.state_dict_to_variables skips them too)
    state = {k: v for k, v in state.items() if "prob_thresh" not in k}
    model.load_state_dict(state, strict=True)
    return int(ckpt.get("epoch", -1))


def save_checkpoint(model: nn.Module, path: str, epoch: int = 0) -> None:
    """Write a reference-schema ``.pth`` ({'epoch', 'model'})."""
    torch.save({"epoch": int(epoch), "model": model.state_dict()}, path)
