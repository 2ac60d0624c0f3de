"""Which conv kernel each conv of a model takes on the card, from its layers:
what a run's launch counters are held to (``conv_kernel.LAUNCHES["conv_tc"]``
against the route rule, ``ops/cuda/conv_kernel.py:conv_route``). The models
themselves never read it."""
from __future__ import annotations

from torch import nn

from mdfnet_tpu_torch.models.layers import (ConvBNReLU, ConvND,
                                            ConvTranspose3dWeight)
from mdfnet_tpu_torch.ops.cuda.conv_kernel import conv_route


def conv_classes(module: nn.Module
                 ) -> list[tuple[int, int, int, int, int, bool]]:
    """(KD, K, stride, Ci, Co, transposed) of every conv of ``module``, in
    module order: each ConvND, at its ConvBNReLU's stride (KD = 1 for a 2D
    conv), and each transposed conv (K3) as (3, 3, 2, Ci, Co, True)."""
    strides = {id(m.conv): m.stride for m in module.modules()
               if isinstance(m, ConvBNReLU)}
    classes = []
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(m, ConvND):
            classes.append((w.shape[2] if w.dim() == 5 else 1, w.shape[-1],
                            strides.get(id(m), 1), w.shape[1], w.shape[0],
                            False))
        elif isinstance(m, ConvTranspose3dWeight):
            classes.append((3, 3, 2, w.shape[0], w.shape[1], True))
    return classes


def eval_conv_routes(model: nn.Module) -> list[str]:
    """The route ("tc", "co1" or "direct") of every conv launch of one eval
    forward
    of a CoreNet on the card, in its compute dtype: each conv and
    transposed conv of the backbone, the U-Nets and refine runs once (the
    chains' layers one launch each)."""
    return [conv_route(model.dtype, *c)
            for m in (model.Backbone, *model.Regular, model.Refine)
            for c in conv_classes(m)]
