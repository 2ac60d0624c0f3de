"""Seeded random weights, made on the device in two large calls and handed
to both sides of the comparison as one state dict.

Each convolution's weight and bias is uniform in +-1/sqrt(fan_in) (torch's
default, fan_in = weight.size(1) x the kernel's taps). BatchNorm starts at
(1, 0) with running statistics (0, 1); with ``sharpen`` its affine and its
running statistics are perturbed (the idea of the port's forward gate,
``chip_smoke.py:sharpen``), and :func:`calibrate_bn` may then set the
running statistics from a forward of the reference.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def make_state(model: nn.Module, seed: int, device, *,
               sharpen: bool) -> dict:
    """A state dict for ``model``'s names and shapes, drawn from ``seed``
    with a generator on ``device``."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    state, at, bounds = {}, 0, {}
    for name, shape in shapes.items():
        n = math.prod(shape)
        u, g = uni[at:at + n].reshape(shape), nrm[at:at + n].reshape(shape)
        at += n
        prefix, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            state[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        if _is_bn(model, prefix):
            value = {"weight": 0.8 + 0.4 * u if sharpen else torch.ones_like(u),
                     "bias": 0.1 * g if sharpen else torch.zeros_like(u),
                     "running_mean": 0.1 * g if sharpen
                     else torch.zeros_like(u),
                     "running_var": 0.5 + u if sharpen
                     else torch.ones_like(u)}[leaf]
        elif leaf == "weight":
            bounds[prefix] = 1.0 / math.sqrt(shape[1] * math.prod(shape[2:]))
            value = (2.0 * u - 1.0) * bounds[prefix]
        else:                                    # a convolution's bias
            value = (2.0 * u - 1.0) * bounds[prefix]
        state[name] = value.contiguous()
    return state


@torch.no_grad()
def calibrate_bn(model: nn.Module, state: dict, args) -> dict:
    """``state`` with every BatchNorm's running statistics replaced by the
    batch statistics of ``model`` (the float32 reference, holding
    ``state``) in a training forward on ``args``, averaged over its calls:
    each layer then normalises what reaches it, and the depth follows the
    scene (with the running statistics of a random network it hardly
    does)."""
    norms = [m for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.momentum = None
        m.reset_running_stats()
    model.train()
    model(*args, train=True)
    after = model.state_dict()
    return {k: after[k].clone() if k.endswith(("running_mean", "running_var"))
            else v for k, v in state.items()}


def _is_bn(model: nn.Module, prefix: str) -> bool:
    return isinstance(model.get_submodule(prefix), nn.modules.batchnorm._BatchNorm)
