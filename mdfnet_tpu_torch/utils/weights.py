"""Weights in the reference ``state_dict`` schema.

The port's module names copy the reference's, so a reference ``.pth`` and a
JAX-exported variable tree (through ``utils/pth_import.py``'s name map) load
with ``load_state_dict(strict=True)`` and no converter.

The alternative units' trees (``ModelConfig.aggregate_impl``,
``refine_impl``) map here too: the variance aggregate has no variables (its
config's U-Nets keep their names, with C input channels), and RefineNet v1,
which the JAX package's ``.pth`` map does not name, takes the port's own
names in the reference's style (:data:`REFINE1`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mdfnet_tpu_torch.utils.pth_import import (_conv_weight_inv, _get,
                                               _module_map,
                                               _trconv_weight_inv)

# RefineNet v1 (JAX ``models/refine.py:RefineNet``): JAX module -> the port's
# state_dict prefix (``models/refine.py:RefineNet``)
REFINE1 = {f"refine/{name}": ("cbr2d", f"Refine.{name}")
           for name in ("conv_img", "conv_depth0", "conv_depth1",
                        "conv_res0")}
REFINE1["refine/conv_depth2"] = ("trcbr2d", "Refine.conv_depth2")
REFINE1["refine/conv_res1"] = ("conv", "Refine.conv_res1")


def _tree_map(params: dict) -> dict:
    """``pth_import``'s name map for the units ``params`` holds: no
    aggregate entries where the tree has no aggregate variables (the
    variance aggregate), RefineNet v1's (:data:`REFINE1`) in place of
    RefineNet2's where the tree's refine unit has ``conv_img``."""
    module_map = _module_map()
    if not any(k.startswith("aggregate") for k in params):
        module_map = {k: v for k, v in module_map.items()
                      if not k.startswith("aggregate")}
    if "conv_img" in params.get("refine", {}):
        module_map = {k: v for k, v in module_map.items()
                      if not k.startswith("refine/")}
        module_map.update(REFINE1)
    return module_map


def _export(sd: dict, params: dict, stats: dict, path: str, spec: tuple):
    """The state_dict entries of the JAX module at ``path`` by its kind
    (``spec``: kind, prefix[, index]); raises KeyError where the tree lacks
    one of its variables."""
    kind, prefix, *idx = spec

    def f32(tree, name):
        return np.asarray(_get(tree, name), dtype=np.float32)

    def bn(at, to):
        sd[f"{to}.weight"] = f32(params, f"{at}/scale")
        sd[f"{to}.bias"] = f32(params, f"{at}/bias")
        sd[f"{to}.running_mean"] = f32(stats, f"{at}/mean")
        sd[f"{to}.running_var"] = f32(stats, f"{at}/var")
        sd[f"{to}.num_batches_tracked"] = np.zeros((), np.int64)

    def conv(at, to, inv=_conv_weight_inv):
        sd[f"{to}.weight"] = inv(f32(params, f"{at}/kernel"))
        if "bias" in _get(params, at):
            sd[f"{to}.bias"] = f32(params, f"{at}/bias")

    if kind == "conv":
        conv(path, prefix)
    elif kind == "bn":
        bn(path, prefix)
    elif kind in ("cbr2d", "cbr3d", "trcbr2d"):
        conv(f"{path}/conv", f"{prefix}.conv",
             _trconv_weight_inv if kind == "trcbr2d" else _conv_weight_inv)
        bn(f"{path}/bn", f"{prefix}.bn")
    elif kind == "trcbr3d":
        conv(f"{path}/conv", f"{prefix}.{idx[0]}", _trconv_weight_inv)
        bn(f"{path}/bn", f"{prefix}.{idx[0] + 1}")
    else:
        raise ValueError(f"unknown kind {kind}")


def jax_variables_to_state_dict(variables) -> dict[str, np.ndarray]:
    """``pth_import.variables_to_state_dict`` for every ModelConfig: the
    name map of the units the tree holds (:func:`_tree_map`), each module
    exported by :func:`_export`. numpy f32 arrays (int64 counters). Raises
    KeyError on a tree that lacks a module or variable of its units."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, np.ndarray] = {}
    for path, spec in _tree_map(params).items():
        try:
            _export(sd, params, stats, path, spec)
        except KeyError as e:
            raise KeyError(f"JAX variables: {path} lacks {e}") from e
    return sd


def state_dict_from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """A JAX model's ``{'params', 'batch_stats'}`` tree (numpy or jax arrays)
    as a torch state_dict in the reference schema, for
    ``model.load_state_dict(..., strict=True)``, for every ModelConfig."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in jax_variables_to_state_dict(variables).items()}


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
