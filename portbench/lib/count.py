"""The work of one forward, counted from the configuration's shapes, and the
least time the card could take for it: the yardstick of every ``*_roofline``
and ``mfu.*`` metric.

The counts come from the frozen reference (``portbench/reference``) run on
the ``meta`` device, with hooks on its layers: they read the same work
whatever implements it, and nothing of what the port launched. The
configuration's architecture (``portbench/archs``) builds the reference,
names its layers and adds each layer's own terms to the convolutions that
this module tallies.

- A convolution's multiply-adds, of every ``nn.Conv1d/2d/3d`` and
  ``nn.ConvTranspose1d/2d/3d``, are counted tap by tap where the tap meets
  the input, with its stride, padding, dilation and groups: the zero
  padding of a convolution and the zeros between a transposed
  convolution's inputs cost nothing, nor does a transposed convolution's
  tap whose output falls outside the output.
- A layer's least time is the larger of its operations over the published
  peak for their type and its bytes over the published bandwidth. The
  special-function units (MUFU) have no published peak and are left out.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from portbench import archs
from portbench.lib.peaks import PEAKS

CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
TRCONVS = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def taps_in(n: int, k: int, stride: int, pad: int, out: int,
            dilation: int = 1) -> int:
    """(output, tap) pairs along one axis of a convolution whose tap reads
    an input element, not the padding: for tap t, the outputs o with
    0 <= o * stride - pad + t * dilation < n. With the input's and the
    output's extents swapped, the (input, tap) pairs of a transposed
    convolution whose output lies inside the output."""
    total = 0
    for t in range(k):
        off = pad - t * dilation
        lo = max(0, -(-off // stride))
        hi = min(out - 1, (n - 1 + off) // stride)
        total += max(0, hi - lo + 1)
    return total


def conv_macs(in_shape, out_shape, weight_shape, stride, pad,
              dilation=None) -> int:
    """Multiply-adds of a convolution: (N, Ci, *in) -> (N, Co, *out), weight
    (Co, Ci / groups, *k), counting only the taps that meet the input."""
    k = weight_shape[2:]
    pairs = math.prod(taps_in(i, kk, s, p, o, d) for i, kk, s, p, o, d in zip(
        in_shape[2:], k, stride, pad, out_shape[2:],
        dilation or (1,) * len(k)))
    return in_shape[0] * weight_shape[0] * weight_shape[1] * pairs


def trconv_macs(in_shape, out_shape, weight_shape, stride, pad,
                dilation=None) -> int:
    """Multiply-adds of a transposed convolution: (N, Ci, *in) -> (N, Co,
    *out), weight (Ci, Co / groups, *k): each input element times each tap
    whose output lies inside the output (``output_padding`` is in its
    shape)."""
    k = weight_shape[2:]
    pairs = math.prod(taps_in(o, kk, s, p, i, d) for i, kk, s, p, o, d in zip(
        in_shape[2:], k, stride, pad, out_shape[2:],
        dilation or (1,) * len(k)))
    return in_shape[0] * weight_shape[0] * weight_shape[1] * pairs


def module_macs(m: nn.Module, in_shape, out_shape) -> int:
    """Multiply-adds of one call of the convolution module ``m``."""
    if isinstance(m.padding, str) or m.padding_mode != "zeros":
        raise ValueError(f"{type(m).__name__}: only numeric zero padding is "
                         f"counted, not {m.padding!r} / {m.padding_mode!r}")
    fn = trconv_macs if isinstance(m, TRCONVS) else conv_macs
    return fn(in_shape, out_shape, m.weight.shape, m.stride, m.padding,
              m.dilation)


class _Tally:
    """The layer the meta forward is in, and each layer's multiply-adds."""

    def __init__(self, layers):
        self.layer = None
        self.macs = {name: 0 for name in layers}


def forward_work(cfg: dict, shapes: dict, *, train: bool) -> dict:
    """The work of one forward at ``shapes`` (``batch``, ``views``,
    ``height``, ``width``) of the model ``cfg`` describes, by layer of its
    architecture: {layer: {"macs", "flops_f32", "bytes", "params"}}.
    Convolutions count as tensor-core work in ``cfg["compute_dtype"]``,
    except in a layer that counts float32 operations (see
    :mod:`portbench.archs`)."""
    arch = archs.of(cfg)
    b, v, h, w = (shapes[k] for k in ("batch", "views", "height", "width"))
    with torch.device("meta"):
        model = arch.build(cfg)
    model.train(train)
    tally = _Tally(arch.LAYERS)
    hooks = []
    for name in arch.LAYERS:
        hooks.append(model.get_submodule(name).register_forward_pre_hook(
            lambda _m, _a, name=name: setattr(tally, "layer", name)))
    for m in model.modules():
        if isinstance(m, CONVS + TRCONVS):
            hooks.append(m.register_forward_hook(
                lambda m, a, o: _add(tally, module_macs(m, a[0].shape,
                                                        o.shape))))
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
                        .parameters()) for name in arch.LAYERS}
    work = arch.layer_work(cfg, shapes, tally.macs, params)
    return {name: dict(work[name], params=params[name])
            for name in arch.LAYERS}


def _add(tally: _Tally, macs: int) -> None:
    tally.macs[tally.layer] += macs


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
    """Seconds of ``work`` at the peak rates: (operations, bytes). A layer
    with float32 operations runs its convolutions inside them (MDF-Net's
    aggregate: its visibility net), so only the other layers'
    multiply-adds go to the tensor cores."""
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

