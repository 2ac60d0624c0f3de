"""What the benchmark knows of MDF-Net (``reference/mdfnet.py``): how a
configuration builds it, its top-level layers, the work of each layer
beyond its convolutions, and the hooks that read each stage's depth.

The work beyond the convolutions:

- The aggregate's float32 operations follow the fused chain (the port's
  ``chip_smoke.py:aggregate_ops``, copied): per (pixel, plane) the G
  sigmoids of the reference's unit vectors; per (pixel, plane, source) the
  projection and taps and, per group, the blend, the sigmoid, the
  similarity, the visibility weight and the accumulation; then G divisions.
  Its visibility net's convolutions run inside that chain.
- A layer's bytes are its inputs, weights and outputs at its boundary,
  each once, at the configuration's dtypes.
"""
from __future__ import annotations

import torch
from torch import nn

from portbench.reference import mdfnet as ref

LAYERS = ("Backbone", "Homoaggre.0", "Homoaggre.1", "Homoaggre.2",
          "Regular.0", "Regular.1", "Regular.2", "Refine")


def build(cfg: dict) -> nn.Module:
    m = cfg["model"]
    return ref.MDFNet(chs=tuple(m["chs"]), ndepths=tuple(m["ndepths"]),
                      ngroups=tuple(m["ngroups"]),
                      curve_classes=tuple(m["curve_classes"]),
                      prob_threshs=tuple(m["prob_threshs"]))


def aggregate_ops(points: int, n_src: int, g: int) -> int:
    """float32 operations of the vector aggregate over ``points`` (pixel,
    plane) pairs."""
    return points * (3 * g + n_src * (38 + 21 * g) + g)


def layer_work(cfg: dict, shapes: dict, macs: dict, params: dict) -> dict:
    """Per layer, its convolutions' multiply-adds (``macs``), the
    aggregates' float32 chain and every layer's boundary bytes."""
    b, v, h, w = (shapes[k] for k in ("batch", "views", "height", "width"))
    item = torch.empty((), dtype=getattr(torch, cfg["compute_dtype"])
                       ).element_size()
    out = {}
    chs = cfg["model"]["chs"]
    for s, (d, g) in enumerate(zip(cfg["model"]["ndepths"],
                                   cfg["model"]["ngroups"])):
        sh, sw = h >> (3 - s), w >> (3 - s)
        c = chs[len(chs) - 1 - s]
        points = b * d * sh * sw
        feats = b * v * sh * sw * c * item
        hypos = (b * d if s == 0 else points) * 4
        out[f"Homoaggre.{s}"] = {
            "macs": macs[f"Homoaggre.{s}"],
            "flops_f32": aggregate_ops(points, v - 1, g),
            "bytes": feats + hypos + points * g * 4}
        out[f"Regular.{s}"] = {
            "macs": macs[f"Regular.{s}"], "flops_f32": 0,
            "bytes": points * g * item + points * 4
            + params[f"Regular.{s}"] * item}
    feats = sum(b * v * (h >> (3 - s)) * (w >> (3 - s))
                * chs[len(chs) - 1 - s] for s in range(3))
    out["Backbone"] = {"macs": macs["Backbone"], "flops_f32": 0,
                       "bytes": (b * v * h * w * 3 + feats
                                 + params["Backbone"]) * item}
    out["Refine"] = {"macs": macs["Refine"], "flops_f32": 0,
                     "bytes": b * (h // 2) * (w // 2) * 4 + b * h * w * 4
                     + params["Refine"] * item}
    return out


def stages(cfg: dict) -> int:
    return len(cfg["model"]["ndepths"])


class Stages:
    """Forward hooks that keep one map's per-stage hypotheses (the
    aggregate's fourth argument) and probability volumes (the U-Net's
    output), from which the stage depths are read."""

    def __init__(self, model, n: int):
        self.hypos, self.probs, self.handles = [None] * n, [None] * n, []
        for s in range(n):
            self.handles.append(model.Homoaggre[s].register_forward_pre_hook(
                lambda _m, a, s=s: self.hypos.__setitem__(s, a[3])))
            self.handles.append(model.Regular[s].register_forward_hook(
                lambda _m, _a, o, s=s: self.probs.__setitem__(s, o)))

    def close(self) -> list:
        for handle in self.handles:
            handle.remove()
        return [(p.float() * hy.float()).sum(1).cpu()
                for p, hy in zip(self.probs, self.hypos)]


def stage_hooks(model, n: int) -> Stages:
    return Stages(model, n)
