"""Differentiable convolutions of the training step (K8).

Port of ``mdfnet_tpu/ops/pallas/conv3d_vjp.py`` (``conv3d_train`` :58,
``trconv3d_train`` :112) and ``mdfnet_tpu/ops/pallas/conv2d_vjp.py``
(``conv2d_train`` :45): ``torch.autograd.Function``s on channels-last
tensors with torch-layout weights, whose forward and input gradient run the
conv kernels of ``conv_kernel.py``:

- forward: K2 (conv3d), K3 (transposed conv3d) or K4 (conv2d) with scale 1,
  offset 0 and no ReLU; train-mode BatchNorm needs the batch statistics OF
  the conv output, so BN and ReLU stay outside (``models/layers.py``);
  K2's, K3's and K4's launches, the input gradients' too, take the kernel
  that ``conv_kernel.conv_route`` gives (the tensor cores for bf16 with Ci,
  Co multiples of 8; the co1 kernel for a stride-1 conv to Co = 1, such as
  ProbConv's forward, whose input gradient, Ci = 1, takes the direct
  kernel);
- d_input of a stride-1 conv: the same conv with the weight flipped in
  space and its (Co, Ci) axes swapped, ``(Co, Ci, k..) -> (Ci, Co, k..)``;
- d_input of a stride-2 conv3d: the transposed conv (K3) with the conv's own
  weight, whose ``(Co, Ci, 3, 3, 3)`` layout is the transposed conv's
  ``(in, out, ...)``, cropped to the input extent (odd extents round up);
- d_input of the transposed conv: the stride-2 conv (K2) with the
  transposed conv's own ``(Ci, Co, 3, 3, 3)`` weight read as ``(out, in)``,
  on the route ``conv_kernel.stream_route`` gives it from its shape and the
  card's SM count: the K-streamed tensor-core conv (``csrc/conv_stream.cu``)
  where the tc kernel's resident tile would leave SMs idle, else
  ``conv_route``'s.

Two parts stay library calls (``torch.nn.grad``), as the JAX package leaves
them to XLA outside any Pallas kernel: d_weight, a small (Co, Ci, k..)
contraction over the whole batch, and the d_input of the stride-2 5x5 conv2d
(the backbone's three downsampling convs, ``conv2d_vjp.py:74-85``). A
hand-written weight-gradient kernel is later work.

An input gradient is computed only when autograd asks for it
(``ctx.needs_input_grad``): the image input of the backbone's first conv and
refine's detached depth need none. The kernel launches that compute an input
gradient count under ``conv_kernel.LAUNCHES["*_dgrad"]``. ``plain=True`` (or
a CPU tensor) runs every conv as its plain PyTorch version.
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch.ops.cuda import conv_kernel, exact_cuda_math
from mdfnet_tpu_torch.ops.cuda.conv_kernel import (conv2d_bn_act,
                                                   conv3d_bn_act,
                                                   trconv3d_bn_act)
from mdfnet_tpu_torch.utils import tracing


@tracing.spanned("prep")
def _identity(c: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.ones(c, device=device), torch.zeros(c, device=device))


def _nc(t: torch.Tensor) -> torch.Tensor:
    """Channels-last (N, ..., C) as a (N, C, ...) view."""
    return t.movedim(-1, 1)


def _library_call(t: torch.Tensor) -> None:
    if t.is_cuda:
        exact_cuda_math()   # no TF32 in the f32 weight gradients


class _Conv3dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, plain):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.plain = stride, plain
        return conv3d_bn_act(x, weight, *_identity(weight.shape[0], x.device),
                             stride=stride, relu=False, plain=plain)

    @staticmethod
    @tracing.spanned("vjp/conv3d")
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            ident = _identity(x.shape[-1], x.device)
            if ctx.stride == 1:
                with tracing.span("prep"):
                    wt = weight.transpose(0, 1).flip(2, 3, 4)
                dx = conv3d_bn_act(g, wt, *ident, relu=False,
                                   plain=ctx.plain, counter="conv3d_dgrad")
            else:
                d, h, w = x.shape[1:4]
                dx = trconv3d_bn_act(g, weight, *ident, relu=False,
                                     plain=ctx.plain, counter="conv3d_dgrad")
                dx = dx[:, :d, :h, :w].contiguous()
        if ctx.needs_input_grad[1]:
            _library_call(x)
            dw = torch.nn.grad.conv3d_weight(_nc(x), weight.shape, _nc(g),
                                             stride=ctx.stride, padding=1)
        return dx, dw, None, None


class _TrConv3dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, plain):
        ctx.save_for_backward(x, weight)
        ctx.plain = plain
        return trconv3d_bn_act(x, weight,
                               *_identity(weight.shape[1], x.device),
                               relu=False, plain=plain)

    @staticmethod
    @tracing.spanned("vjp/trconv3d")
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            route = None
            if g.is_cuda and not ctx.plain:
                route = conv_kernel.stream_route(
                    g.dtype, 3, 3, 2, g.shape[-1], weight.shape[0],
                    tuple(g.shape[:4]),
                    conv_kernel.sm_count(g.device.index))
            dx = conv3d_bn_act(g, weight, *_identity(x.shape[-1], x.device),
                               stride=2, relu=False, plain=ctx.plain,
                               counter="trconv3d_dgrad", route=route)
        if ctx.needs_input_grad[1]:
            # the transposed conv's adjoint in x is the stride-2 conv of g
            # with this weight, so its weight gradient is that conv's
            _library_call(x)
            dw = torch.nn.grad.conv3d_weight(_nc(g), weight.shape, _nc(x),
                                             stride=2, padding=1)
        return dx, dw, None


class _Conv2dTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, plain):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.plain = stride, plain
        return conv2d_bn_act(x, weight, *_identity(weight.shape[0], x.device),
                             stride=stride, relu=False, plain=plain)

    @staticmethod
    @tracing.spanned("vjp/conv2d")
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        pad = weight.shape[-1] // 2
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.stride == 1:
                with tracing.span("prep"):
                    wt = weight.transpose(0, 1).flip(2, 3)
                dx = conv2d_bn_act(g, wt, *_identity(x.shape[-1], x.device),
                                   relu=False, plain=ctx.plain,
                                   counter="conv2d_dgrad")
            else:
                _library_call(x)
                dx = torch.nn.grad.conv2d_input(
                    _nc(x).shape, weight, _nc(g), stride=2, padding=pad)
                dx = dx.movedim(1, -1).contiguous()
        if ctx.needs_input_grad[1]:
            _library_call(x)
            dw = torch.nn.grad.conv2d_weight(_nc(x), weight.shape, _nc(g),
                                             stride=ctx.stride, padding=pad)
        return dx, dw, None, None


def conv3d_train(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, *,
                 plain: bool = False) -> torch.Tensor:
    """Conv3d(3x3x3, stride 1 or 2, pad 1, no bias) with its backward on the
    kernels. x (N, D, H, W, Ci); weight (Co, Ci, 3, 3, 3) in x's dtype.
    Returns (N, ceil(D/s), ceil(H/s), ceil(W/s), Co) in x's dtype."""
    return _Conv3dTrain.apply(x.contiguous(), weight, stride, plain)


def trconv3d_train(x: torch.Tensor, weight: torch.Tensor, *,
                   plain: bool = False) -> torch.Tensor:
    """ConvTranspose3d(3, stride 2, pad 1, output_padding 1, no bias) with
    its backward on the kernels. x (N, D, H, W, Ci); weight
    (Ci, Co, 3, 3, 3), torch's layout. Returns (N, 2D, 2H, 2W, Co)."""
    return _TrConv3dTrain.apply(x.contiguous(), weight, plain)


def conv2d_train(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, *,
                 plain: bool = False) -> torch.Tensor:
    """Conv2d(k x k, k in {1, 3, 5}, stride 1 or 2, pad k//2, no bias) with
    its backward on the kernels. x (N, H, W, Ci); weight (Co, Ci, k, k).
    Returns (N, ceil(H/s), ceil(W/s), Co) in x's dtype."""
    return _Conv2dTrain.apply(x.contiguous(), weight, stride, plain)
