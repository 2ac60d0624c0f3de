"""Weights in the reference ``state_dict`` schema from the JAX package's
variable trees (counterpart of ``mdfnet_tpu/utils/pth_import.py``, export
direction only).

:func:`variables_to_state_dict` maps a ``{'params', 'batch_stats'}`` tree of
the JAX CoreNet (numpy arrays; any array type that ``np.asarray`` takes) onto
the reference CoreNet's torch ``state_dict`` names, which the port's modules
carry. Layout conversions:
    Conv{2,3}d  (*k, I, O) -> torch (O, I, *k)
    ConvTranspose3d (*k, O, I) -> torch (I, O, *k)
    BatchNorm scale/bias -> weight/bias; batch_stats -> running stats.

numpy only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# name maps: JAX module path -> reference state_dict prefix
# ---------------------------------------------------------------------------

_BACKBONE = {}
for _stack, _n in (("conv01", 2), ("conv12", 3), ("conv23", 3), ("conv34", 3)):
    for _i in range(_n):
        _BACKBONE[f"{_stack}_{_i}"] = ("cbr2d", f"Backbone.{_stack}.{_i}")
for _name in ("lat2", "lat3", "out2", "out3", "out4"):
    _BACKBONE[_name] = ("conv", f"Backbone.{_name}")

_REGULAR0 = {}
for _stack, _n in (("conv01", 2), ("conv12", 3), ("conv232", 3)):
    for _i in range(_n):
        _REGULAR0[f"{_stack}_{_i}"] = ("cbr3d", f"Regular.0.{_stack}.{_i}")
_REGULAR0["conv232_3"] = ("trcbr3d", "Regular.0.conv232", 3)
_REGULAR0["conv10"] = ("trcbr3d", "Regular.0.conv10", 0)
_REGULAR0["prob"] = ("conv", "Regular.0.prob")


def _regular4(idx: int) -> Dict:
    m = {"conv01": ("cbr3d", f"Regular.{idx}.conv01")}
    for _stack in ("conv12", "conv23", "conv343"):
        for _i in range(2):
            m[f"{_stack}_{_i}"] = ("cbr3d", f"Regular.{idx}.{_stack}.{_i}")
    m["conv343_2"] = ("trcbr3d", f"Regular.{idx}.conv343", 2)
    m["trconv32"] = ("trcbr3d", f"Regular.{idx}.trconv32", 0)
    m["trconv21"] = ("trcbr3d", f"Regular.{idx}.trconv21", 0)
    m["prob"] = ("conv", f"Regular.{idx}.prob")
    return m


def _aggregate(idx: int) -> Dict:
    p = f"Homoaggre.{idx}.depth_weight"
    return {
        "depth_weight/conv0": ("conv", f"{p}.0.conv"),
        "depth_weight/bn0": ("bn", f"{p}.0.bn"),
        "depth_weight/conv1": ("conv", f"{p}.1"),
    }


_REFINE = {
    "conv0": ("conv", "Refine.conv0"),
    "conv1": ("conv", "Refine.conv1"),
    "conv2_0": ("conv", "Refine.conv2.0"),
    "conv2_1": ("conv", "Refine.conv2.2"),
}
for _i in range(3):
    _REFINE[f"res{_i}/conv0"] = ("conv", f"Refine.ress.{_i}.conv.0")
    _REFINE[f"res{_i}/conv1"] = ("conv", f"Refine.ress.{_i}.conv.2")


def _module_map() -> Dict[str, Tuple]:
    """Full map: 'jax/module/path' -> (kind, reference prefix, ...)."""
    out = {}
    for k, v in _BACKBONE.items():
        out[f"backbone/{k}"] = v
    for s in range(3):
        for k, v in _aggregate(s).items():
            out[f"aggregate{s}/{k}"] = v
    for k, v in _REGULAR0.items():
        out[f"regular0/{k}"] = v
    for s in (1, 2):
        for k, v in _regular4(s).items():
            out[f"regular{s}/{k}"] = v
    for k, v in _REFINE.items():
        out[f"refine/{k}"] = v
    return out


# ---------------------------------------------------------------------------
# export: JAX variables -> reference state_dict
# ---------------------------------------------------------------------------

def _get(tree: dict, path: str) -> np.ndarray:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _conv_weight_inv(w: np.ndarray) -> np.ndarray:
    """(*k, I, O) -> torch (O, I, *k)."""
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def _trconv_weight_inv(w: np.ndarray) -> np.ndarray:
    """(*k, O, I) -> torch ConvTranspose (I, O, *k)."""
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def variables_to_state_dict(variables: Dict) -> Dict[str, np.ndarray]:
    """Convert the JAX CoreNet's variables to a reference CoreNet
    state_dict (numpy f32 arrays): transposed weights, and every BatchNorm
    with the ``num_batches_tracked`` counter torch includes in its
    state_dict (int64 zero: the reference never consumes it)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def to_np(a):
        return np.asarray(a, dtype=np.float32)

    def export_conv(path, ref_prefix):
        sd[f"{ref_prefix}.weight"] = _conv_weight_inv(to_np(_get(params, f"{path}/kernel")))
        try:
            sd[f"{ref_prefix}.bias"] = to_np(_get(params, f"{path}/bias"))
        except KeyError:
            pass

    def export_bn(path, ref_prefix):
        sd[f"{ref_prefix}.weight"] = to_np(_get(params, f"{path}/scale"))
        sd[f"{ref_prefix}.bias"] = to_np(_get(params, f"{path}/bias"))
        sd[f"{ref_prefix}.running_mean"] = to_np(_get(stats, f"{path}/mean"))
        sd[f"{ref_prefix}.running_var"] = to_np(_get(stats, f"{path}/var"))
        sd[f"{ref_prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    for path, spec in _module_map().items():
        kind = spec[0]
        if kind == "conv":
            export_conv(path, spec[1])
        elif kind == "bn":
            export_bn(path, spec[1])
        elif kind in ("cbr2d", "cbr3d"):
            export_conv(f"{path}/conv", f"{spec[1]}.conv")
            export_bn(f"{path}/bn", f"{spec[1]}.bn")
        elif kind == "trcbr3d":
            prefix, conv_idx = spec[1], spec[2]
            w = to_np(_get(params, f"{path}/conv/kernel"))
            sd[f"{prefix}.{conv_idx}.weight"] = _trconv_weight_inv(w)
            export_bn(f"{path}/bn", f"{prefix}.{conv_idx + 1}")
        else:
            raise ValueError(f"unknown kind {kind}")
    return sd

