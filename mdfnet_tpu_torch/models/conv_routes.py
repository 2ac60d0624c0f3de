"""Which conv kernel each conv of a model takes on the card, from its layers:
what a run's launch counters are held to (``conv_kernel.LAUNCHES["conv_tc"]``
against the route rule, ``ops/cuda/conv_kernel.py:conv_route``, and the
chain kernel's launches against ``chain_route``). The models themselves
never read it."""
from __future__ import annotations

from torch import nn

from mdfnet_tpu_torch.models.layers import (ConvBNReLU, ConvND,
                                            ConvTranspose2dWeight,
                                            ConvTranspose3dWeight)
from mdfnet_tpu_torch.ops.cuda.conv_kernel import (CHAIN_FUSED, chain_plan,
                                                   chain_route, conv_route)


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
