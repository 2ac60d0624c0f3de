"""Which conv kernel each conv of a model takes on the card, from its layers:
what a run's launch counters are held to (``conv_kernel.LAUNCHES["conv_tc"]``
against the route rule, ``ops/cuda/conv_kernel.py:conv_route``, and the
chain kernel's launches against ``chain_route``). The models themselves
never read it."""
from __future__ import annotations

import torch
from torch import nn

from mdfnet_tpu_torch.models.layers import (ConvBNReLU, ConvND,
                                            ConvTranspose2dWeight,
                                            ConvTranspose3dWeight)
from mdfnet_tpu_torch.ops.cuda.conv_kernel import (CHAIN_FUSED, chain_plan,
                                                   chain_route, conv_route,
                                                   stream_route)


def conv_classes(module: nn.Module, skip=frozenset()
                 ) -> list[tuple[int, int, int, int, int, bool]]:
    """(KD, K, stride, Ci, Co, transposed) of every conv of ``module``, in
    module order: each ConvND, at its ConvBNReLU's stride (KD = 1 for a 2D
    conv), and each transposed conv (K3) as (3, 3, 2, Ci, Co, True); a
    ConvND whose id is in ``skip`` is left out."""
    strides = {id(m.conv): m.stride for m in module.modules()
               if isinstance(m, ConvBNReLU)}
    classes = []
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(m, ConvND) and id(m) not in skip:
            classes.append((w.shape[2] if w.dim() == 5 else 1, w.shape[-1],
                            strides.get(id(m), 1), w.shape[1], w.shape[0],
                            False))
        elif isinstance(m, ConvTranspose2dWeight):
            classes.append((1, 3, 1, w.shape[0], w.shape[1], False))
        elif isinstance(m, ConvTranspose3dWeight):
            classes.append((3, 3, 2, w.shape[0], w.shape[1], True))
    return classes


def eval_conv_routes(model: nn.Module) -> list[str]:
    """The route of every conv launch of one eval forward of a CoreNet on
    the card, in its compute dtype: "chain" once per launch of the chain
    kernel (each segment of each chain that chain_route fuses), and "tc",
    "co1" or "direct" once for every other conv and transposed conv of the
    backbone, the U-Nets and refine (a chain on the per-layer route, and a
    layer of a fused chain that no segment takes, launch each such layer
    by conv_route). The backbone's lateral and out 1x1 convs run as the
    three composed convs of its linearised top-down path."""
    bb = model.Backbone
    routes = [conv_route(model.dtype, 1, 1, 1, w.shape[1], w.shape[0])
              for w, *_ in bb.top_down_weights(model.dtype)]
    skip = {id(m) for m in (bb.lat2, bb.lat3, bb.out2, bb.out3, bb.out4)}
    for mod in (bb, model.Refine):
        for layers, relus, residuals, final_stride in mod.eval_chains():
            convs = [getattr(m, "conv", m) for m in layers]
            specs = tuple((c.weight.shape[-1], c.weight.shape[1],
                           c.weight.shape[0]) for c in convs)
            key = (specs, relus, residuals, final_stride)
            if chain_route(model.dtype, *key) == "fused":
                for seg in chain_plan(*key, CHAIN_FUSED[key]):
                    routes.append("chain")
                    skip |= {id(c) for c in convs[seg.first:seg.last + 1]}
    return routes + [conv_route(model.dtype, *c)
                     for m in (bb, *model.Regular, model.Refine)
                     for c in conv_classes(m, skip)]


def unet_launches(unet: nn.Module, shape: tuple) -> list[tuple]:
    """(KD, K, stride, input shape (N, D, H, W, Ci), Co, transposed) of
    every conv and transposed conv of a U-Net (``models/regularize.py``)
    in forward order, from its input's (N, D, H, W) ``shape``: a stride-2
    conv halves D, H and W (rounding up), a transposed conv doubles them."""
    n, d, h, w = shape
    out = []
    for kd, k, s, ci, co, tr in conv_classes(unet):
        out.append((kd, k, s, (n, d, h, w, ci), co, tr))
        if tr:
            d, h, w = 2 * d, 2 * h, 2 * w
        elif s == 2:
            d, h, w = -(-d // 2), -(-h // 2), -(-w // 2)
    return out


def train_unet_routes(model: nn.Module, batch: int, height: int,
                      width: int, sms: int) -> list[tuple]:
    """The route of every conv launch of the U-Nets in one bf16 train step
    of ``batch`` items at ``height`` x ``width`` on a card of ``sms`` SMs,
    forward and input gradients (``ops/cuda/conv_vjp.py``), stage by stage
    (stage s's volume: ``model.ndepths[s]`` planes at 1/2^(3-s) of the
    image): (what, KD, K, stride, input shape, Co, transposed, route).
    "forward": the conv itself, by conv_route; "dgrad": its input
    gradient, a conv of the output's shape back to Ci channels (stride 1:
    by conv_route; a stride-2 conv's: the transposed conv, by conv_route;
    a transposed conv's: the stride-2 conv, by stream_route). The ProbConv
    (Ci -> 1) of each stage is among them; its input gradient (1 -> Ci)
    too."""
    dt = torch.bfloat16
    out = []
    for stage, unet in enumerate(model.Regular):
        shape = (batch, model.ndepths[stage], height >> (3 - stage),
                 width >> (3 - stage))
        for kd, k, s, xs, co, tr in unet_launches(unet, shape):
            ci = xs[-1]
            out.append(("forward", kd, k, s, xs, co, tr,
                        conv_route(dt, kd, k, s, ci, co, tr)))
            n, d, h, w = xs[:4]
            if tr:
                g = (n, 2 * d, 2 * h, 2 * w)
                route = stream_route(dt, 3, 3, 2, co, ci, g, sms)
                out.append(("dgrad", 3, 3, 2, (*g, co), ci, False, route))
            elif s == 2:
                g = (n, -(-d // 2), -(-h // 2), -(-w // 2))
                out.append(("dgrad", 3, 3, 2, (*g, co), ci, True,
                            conv_route(dt, 3, 3, 2, co, ci, True)))
            else:
                out.append(("dgrad", kd, k, 1, (n, d, h, w, co), ci, False,
                            conv_route(dt, kd, k, 1, co, ci)))
    return out
