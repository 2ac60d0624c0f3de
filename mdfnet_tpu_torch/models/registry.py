"""Config-driven model assembly (port of ``mdfnet_tpu/models/registry.py``).

Reads the topology fields of ``mdfnet_tpu.config.ModelConfig`` and its
``compute_dtype``; the TPU-only fields (``warp_impl``, ``pallas_conv``,
``wfold``, ``remat``) select nothing here.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mdfnet_tpu.config import ModelConfig
from mdfnet_tpu_torch.models.core import CoreNet
from mdfnet_tpu_torch.models.layers import init_parameters

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(config: ModelConfig | None = None, *,
                compute_dtype: str | None = None, seed: int = 0,
                device: str | torch.device = "cpu") -> CoreNet:
    """An eval-mode CoreNet with torch-default random weights drawn from a
    ``torch.Generator`` seeded with ``seed``. ``config`` defaults to the
    default ``ModelConfig``; ``compute_dtype`` ("float32" or "bfloat16"),
    when given, replaces the config's."""
    config = config or ModelConfig()
    if compute_dtype is not None:
        config = dataclasses.replace(config, compute_dtype=compute_dtype)
    alternatives = {"aggregate_impl": "vector", "hypo_impl": "fit",
                    "refine_impl": "refine2"}
    for field, ported in alternatives.items():
        if getattr(config, field) != ported:
            raise NotImplementedError(
                f"{field}={getattr(config, field)!r} is not ported yet")
    model = CoreNet(chs=config.chs, ndepths=config.ndepths,
                    curve_classes=config.curve_classes,
                    prob_threshs=config.prob_threshs,
                    ngroups=config.ngroups,
                    dtype=_DTYPES[config.compute_dtype])
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)


def count_params(model: nn.Module) -> int:
    """Learnable parameters (BN running statistics excluded)."""
    return sum(p.numel() for p in model.parameters())
