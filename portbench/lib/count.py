"""The work of one forward, counted from the configuration's shapes, and the
least time the card could take for it: the yardstick of every ``*_roofline``
and ``mfu.*`` metric.

The counts come from the frozen reference (``portbench/reference``) run on
the ``meta`` device, with hooks on its layers: they read the same work
whatever implements it, and nothing of what the port launched.

- A convolution's multiply-adds are counted tap by tap where the tap meets
  the input: the zero padding of a convolution and the zeros between a
  transposed convolution's inputs cost nothing.
- The aggregate's float32 operations follow the fused chain (the port's
  ``chip_smoke.py:aggregate_ops``, copied): per (pixel, plane) the G
  sigmoids of the reference's unit vectors; per (pixel, plane, source) the
  projection and taps and, per group, the blend, the sigmoid, the
  similarity, the visibility weight and the accumulation; then G divisions.
- A layer's bytes are its inputs, weights and outputs at its boundary,
  each once, at the configuration's dtypes.
- A layer's least time is the larger of its operations over the published
  peak for their type and its bytes over the published bandwidth. The
  special-function units (MUFU) have no published peak and are left out.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from portbench.lib.peaks import PEAKS
from portbench.reference import mdfnet as ref

LAYERS = ("Backbone", "Homoaggre.0", "Homoaggre.1", "Homoaggre.2",
          "Regular.0", "Regular.1", "Regular.2", "Refine")


def taps_in(n: int, k: int, stride: int, pad: int, out: int) -> int:
    """(output, tap) pairs along one axis of a convolution whose tap reads
    an input element, not the padding: for tap t, the outputs o with
    0 <= o * stride - pad + t < n."""
    total = 0
    for t in range(k):
        lo = max(0, -(-(pad - t) // stride))
        hi = min(out - 1, (n - 1 + pad - t) // stride)
        total += max(0, hi - lo + 1)
    return total


def conv_macs(in_shape, out_shape, weight_shape, stride, pad) -> int:
    """Multiply-adds of a convolution: (N, Ci, *in) -> (N, Co, *out), weight
    (Co, Ci, *k), counting only the taps that meet the input."""
    n, ci = in_shape[:2]
    co, k = weight_shape[0], weight_shape[2:]
    pairs = math.prod(taps_in(i, kk, s, p, o) for i, kk, s, p, o in zip(
        in_shape[2:], k, stride, pad, out_shape[2:]))
    return n * ci * co * pairs


def trconv_macs(in_shape, weight_shape) -> int:
    """Multiply-adds of a k3, stride 2, padding 1, output_padding 1
    transposed convolution, weight (Ci, Co, 3, 3, 3): each input element
    times each tap whose output lies inside [0, 2n), 3n - 1 per axis."""
    n, ci = in_shape[:2]
    co = weight_shape[1]
    return n * ci * co * math.prod(3 * d - 1 for d in in_shape[2:])


def aggregate_ops(points: int, n_src: int, g: int) -> int:
    """float32 operations of the vector aggregate over ``points`` (pixel,
    plane) pairs."""
    return points * (3 * g + n_src * (38 + 21 * g) + g)


class _Tally:
    """The layer the meta forward is in, and each layer's multiply-adds."""

    def __init__(self):
        self.layer = None
        self.macs = {name: 0 for name in LAYERS}


def forward_work(cfg: dict, shapes: dict, *, train: bool) -> dict:
    """The work of one forward at ``shapes`` (``batch``, ``views``,
    ``height``, ``width``) of the model ``cfg`` describes, by layer:
    {layer: {"macs", "flops_f32", "bytes", "params"}}. Convolutions count as bf16
    tensor-core work (``cfg["compute_dtype"]``), the aggregate's chain as
    float32 operations."""
    b, v, h, w = (shapes[k] for k in ("batch", "views", "height", "width"))
    item = torch.empty((), dtype=getattr(torch, cfg["compute_dtype"])
                       ).element_size()
    with torch.device("meta"):
        model = ref.MDFNet(**model_args(cfg))
    model.train(train)
    tally = _Tally()
    hooks = []
    for name in LAYERS:
        hooks.append(model.get_submodule(name).register_forward_pre_hook(
            lambda _m, _a, name=name: setattr(tally, "layer", name)))
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            hooks.append(m.register_forward_hook(
                lambda m, a, o: _add(tally, conv_macs(
                    a[0].shape, o.shape, m.weight.shape, m.stride,
                    m.padding))))
        elif isinstance(m, nn.ConvTranspose3d):
            hooks.append(m.register_forward_hook(
                lambda m, a, o: _add(tally, trconv_macs(a[0].shape,
                                                        m.weight.shape))))
    args = (torch.empty(b, v, h, w, 3, device="meta"),
            torch.empty(b, v, 4, 4, device="meta"),
            torch.empty(b, v, 3, 3, device="meta"),
            torch.empty(b, 2, device="meta"))
    try:
        model(*args, train=train)
    finally:
        for hk in hooks:
            hk.remove()
    params = {name: sum(p.numel() for p in model.get_submodule(name)
                        .parameters()) for name in LAYERS}
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
            "macs": tally.macs[f"Homoaggre.{s}"],
            "flops_f32": aggregate_ops(points, v - 1, g),
            "bytes": feats + hypos + points * g * 4}
        out[f"Regular.{s}"] = {
            "macs": tally.macs[f"Regular.{s}"], "flops_f32": 0,
            "bytes": points * g * item + points * 4
            + params[f"Regular.{s}"] * item}
    feats = sum(b * v * (h >> (3 - s)) * (w >> (3 - s))
                * chs[len(chs) - 1 - s] for s in range(3))
    out["Backbone"] = {"macs": tally.macs["Backbone"], "flops_f32": 0,
                       "bytes": (b * v * h * w * 3 + feats
                                 + params["Backbone"]) * item}
    out["Refine"] = {"macs": tally.macs["Refine"], "flops_f32": 0,
                     "bytes": b * (h // 2) * (w // 2) * 4 + b * h * w * 4
                     + params["Refine"] * item}
    return {name: dict(out[name], params=params[name]) for name in LAYERS}


def _add(tally: _Tally, macs: int) -> None:
    tally.macs[tally.layer] += macs


def model_args(cfg: dict) -> dict:
    m = cfg["model"]
    return dict(chs=tuple(m["chs"]), ndepths=tuple(m["ndepths"]),
                ngroups=tuple(m["ngroups"]),
                curve_classes=tuple(m["curve_classes"]),
                prob_threshs=tuple(m["prob_threshs"]))


def least_ms(work: dict, passes: int = 1) -> float:
    """The least time of ``work`` (one layer's entry of :func:`forward_work`)
    run ``passes`` times (3 for a training step: the forward, the input
    gradients and the weight gradients), in ms: the larger of its
    operations over their peaks and its bytes over the bandwidth."""
    t_ops, t_bytes = _times(work)
    return passes * max(t_ops, t_bytes) * 1e3


def bound_by(work: dict) -> str:
    """Which of the two bounds binds ``work``."""
    t_ops, t_bytes = _times(work)
    return "operations" if t_ops >= t_bytes else "bytes"


def _times(work: dict) -> tuple[float, float]:
    """Seconds of ``work`` at the peak rates: (operations, bytes). The
    aggregate's convolutions (its visibility net) are float32 work inside
    its chain's count, so only the other layers' go to the tensor cores."""
    tensor = 0 if work["flops_f32"] else work["macs"]
    return (2 * tensor / PEAKS["bf16_tensor_flops"]
            + work["flops_f32"] / PEAKS["f32_flops"],
            work["bytes"] / PEAKS["hbm_bytes_per_s"])


def conv_flops(work: dict) -> int:
    """2 x the multiply-adds of every convolution of a forward."""
    return sum(2 * w["macs"] for w in work.values())


def adam_bytes(n_params: int) -> int:
    """Adam's traffic a step: parameter, gradient and both moments read,
    parameter and moments written, float32."""
    return 28 * n_params

