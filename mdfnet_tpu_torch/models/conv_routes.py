"""Which conv kernel each conv of a model takes on the card, from its layers:
what a run's launch counters are held to (``conv_kernel.LAUNCHES["conv_tc"]``
against the route rule, ``ops/cuda/conv_kernel.py:conv_route``). The models
themselves never read it."""
from __future__ import annotations

from torch import nn

from mdfnet_tpu_torch.models.layers import ConvBNReLU, ConvND
from mdfnet_tpu_torch.ops.cuda.conv_kernel import conv_route


def conv_classes(module: nn.Module) -> list[tuple[int, int, int, int, int]]:
    """(KD, K, stride, Ci, Co) of every conv of ``module``, in module order:
    each ConvND, at its ConvBNReLU's stride (KD = 1 for a 2D conv). The
    transposed convs (K3) are not among them."""
    strides = {id(m.conv): m.stride for m in module.modules()
               if isinstance(m, ConvBNReLU)}
    return [(m.weight.shape[2] if m.weight.dim() == 5 else 1,
             m.weight.shape[-1], strides.get(id(m), 1), m.weight.shape[1],
             m.weight.shape[0])
            for m in module.modules() if isinstance(m, ConvND)]


def eval_conv_routes(model: nn.Module) -> list[str]:
    """The route ("tc" or "direct") of every conv launch of one eval forward
    of a CoreNet on the card, in its compute dtype: each conv of the
    backbone, the U-Nets and refine runs once (the chains' layers one launch
    each); the transposed convs are not among them."""
    return [conv_route(model.dtype, *c)
            for m in (model.Backbone, *model.Regular, model.Refine)
            for c in conv_classes(m)]
