"""Config-driven model assembly (port of ``mdfnet_tpu/models/registry.py``).

Reads the topology fields of :class:`mdfnet_tpu_torch.config.ModelConfig`
(the alternative units ``aggregate_impl``, ``hypo_impl``, ``refine_impl``
and ``gauss0`` curves among them), its ``compute_dtype`` and its
``warp_impl``: ``"fused"`` selects the fused
train aggregate (``ops/aggregate_train.py``: the stats kernel, then the
aggregate kernel with a per-view BatchNorm affine) in training, as
``warp_impl="fused"`` does in the JAX package; eval runs the same kernels
whatever it says. The other JAX-only fields (``pallas_conv``, ``wfold``,
``remat``) select nothing here.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.models.core import CoreNet
from mdfnet_tpu_torch.models.layers import init_parameters

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no card (an entry point never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (device='cpu', or --device cpu on a CLI)")
    return device


def build_model(config: ModelConfig | None = None, *,
                compute_dtype: str | None = None, seed: int = 0,
                device: str | torch.device = "cuda") -> CoreNet:
    """An eval-mode CoreNet on ``device`` (the card unless the caller asks
    for the CPU) with torch-default random weights drawn from a
    ``torch.Generator`` seeded with ``seed``. ``config`` defaults to the
    default ``ModelConfig``; ``compute_dtype`` ("float32" or "bfloat16"),
    when given, replaces the config's."""
    config = config or ModelConfig()
    if compute_dtype is not None:
        config = dataclasses.replace(config, compute_dtype=compute_dtype)
    alternatives = (config.aggregate_impl != "vector"
                    or config.hypo_impl != "fit"
                    or config.refine_impl != "refine2")
    if alternatives and config.warp_impl == "fused":
        raise ValueError(
            "warp_impl='fused' trains the vector aggregate (K9) only: the "
            "alternative units (aggregate_impl, hypo_impl, refine_impl) take "
            "another warp_impl, as in the JAX package")
    device = resolve_device(device)
    model = CoreNet(chs=config.chs, ndepths=config.ndepths,
                    curve_classes=config.curve_classes,
                    prob_threshs=config.prob_threshs,
                    ngroups=config.ngroups,
                    dtype=_DTYPES[config.compute_dtype],
                    warp_impl=config.warp_impl,
                    aggregate_impl=config.aggregate_impl,
                    hypo_impl=config.hypo_impl,
                    refine_impl=config.refine_impl)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)


def count_params(model: nn.Module) -> int:
    """Learnable parameters (BN running statistics excluded)."""
    return sum(p.numel() for p in model.parameters())
