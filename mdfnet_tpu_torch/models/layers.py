"""Building blocks in the reference ``state_dict`` schema (port of
``mdfnet_tpu/models/layers.py``).

Weights keep torch's layouts: conv ``(O, I, *k)``, ConvTranspose3d
``(I, O, *k)``; BatchNorm keeps ``weight, bias, running_mean, running_var,
num_batches_tracked``. Activations are channels-last (NHWC / NDHWC).

Eval folds BatchNorm into the conv kernels' epilogue. Train (``train=True``)
runs the conv alone through the differentiable kernels of
``ops/cuda/conv_vjp.py`` (K8), then batch-statistics BatchNorm in f32, then
the ReLU. Every ``forward`` takes ``plain``: True runs the kernels' plain
PyTorch versions (also on the card), False launches the CUDA kernels for
CUDA tensors (CPU tensors always take the plain versions).

Under spatial sharding of the eval forward (``parallel/halo.py``) every
conv runs band-wise, as the JAX package runs its own Pallas convs
(``layers.py:484-488,653-657``): the band is extended by the rows its
outputs read from the neighbouring bands (``halo.conv_halo``: the padding
p a side at stride 1; at stride 2, p above rounded up to 2 and p - 1
below; the transposed conv one below), the UNCHANGED kernel runs on the
extended band, and the output rows that the kernel's own zero padding
touched are dropped (``halo.banded``). The extra rows go to the kernels as
a taller input; at the image's top and bottom edges no rows are added, so
the kernels' zero padding is the image's. Training has no spatial
sharding.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from mdfnet_tpu_torch.ops.cuda.conv_kernel import (
    conv2d_bn_act, conv3d_bn_act, trconv3d_bn_act)
from mdfnet_tpu_torch.ops.cuda.conv_vjp import (conv2d_train, conv3d_train,
                                                trconv3d_train)
from mdfnet_tpu_torch.parallel import halo


def h_axis(x: torch.Tensor) -> int:
    """The H axis of a channels-last (N, H, W, C) or (N, D, H, W, C)."""
    return x.dim() - 3


class BatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis with torch semantics and
    torch's parameter/buffer names (eps 1e-5, momentum 0.1).

    Eval normalises with the running statistics. Train normalises with the
    batch's biased variance, in f32, and moves the running statistics
    towards the batch mean and the UNBIASED variance; ``num_batches_tracked``
    counts the updates. While ``recomputing`` is set (by the remat wrapper,
    ``models/core.py``, as the backward recomputes a forward), train leaves
    the running statistics alone: the first pass updated them."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.recomputing = False

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, offset) with bn(x) == x * scale + offset, in f32."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                  + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale

    def forward(self, x: torch.Tensor, train: bool = False,
                vgroups: int = 1) -> torch.Tensor:
        """``vgroups`` > 1 (train): x stacks that many independent calls
        along its leading axis, view-major (the train backbone's views);
        each gets its own statistics, exactly as that many sequential calls
        would, and the running statistics take the closed form of those
        calls' EMA updates: ra <- (1-m)^V ra + m sum_v (1-m)^(V-1-v) s_v."""
        if not train:
            scale, offset = self.fold()
            return (x.float() * scale + offset).to(x.dtype)
        ch = x.shape[-1]
        xs = x.float().reshape((vgroups, -1) + x.shape[1:])
        axes = tuple(range(1, xs.dim() - 1))
        var, mean = torch.var_mean(xs, dim=axes, correction=0,
                                   keepdim=True)                  # (V,1..,C)
        if not self.recomputing:
            with torch.no_grad():
                m, n = self.momentum, x.numel() // (ch * vgroups)
                w = m * (1.0 - m) ** torch.arange(vgroups - 1, -1, -1,
                                                  dtype=torch.float32,
                                                  device=x.device)
                unbiased = var.reshape(vgroups, ch) * (n / max(n - 1, 1))
                self.running_mean.mul_((1.0 - m) ** vgroups).add_(
                    w @ mean.reshape(vgroups, ch))
                self.running_var.mul_((1.0 - m) ** vgroups).add_(
                    w @ unbiased)
                self.num_batches_tracked.add_(vgroups)
        y = ((xs - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
             + self.bias.float())
        return y.reshape(x.shape).to(x.dtype)

    @torch.no_grad()
    def update_running_stats(self, means: torch.Tensor,
                             unbiased_vars: torch.Tensor) -> None:
        """The running-statistics updates of V train calls whose batch
        statistics were computed elsewhere (the fused train aggregate's
        stats kernel): V sequential EMA updates in order, from each call's
        batch mean and unbiased variance (``means``, ``unbiased_vars``: (V,)
        for one channel, or (V, C))."""
        m = self.momentum
        if self.recomputing:
            return
        for mean, var in zip(means, unbiased_vars):
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        self.num_batches_tracked.add_(len(means))


class ConvND(nn.Module):
    """Conv weight (and optional bias) in torch layout (O, I, *k); runs as a
    plain conv (scale 1, offset = bias) through the conv kernels."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 ndim: int = 2, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (out_ch, in_ch) + (kernel_size,) * ndim))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def epilogue(self) -> tuple[torch.Tensor, torch.Tensor]:
        co = self.weight.shape[0]
        ones = torch.ones(co, device=self.weight.device)
        offset = (self.bias.float() if self.bias is not None
                  else torch.zeros(co, device=self.weight.device))
        return ones, offset

    def forward(self, x: torch.Tensor, *,
                residual: torch.Tensor | None = None, out_dtype=None,
                plain: bool = False) -> torch.Tensor:
        conv = conv3d_bn_act if self.weight.dim() == 5 else conv2d_bn_act
        scale, offset = self.epilogue()
        w = self.weight.to(x.dtype)
        lo, hi = halo.conv_halo(w.shape[-1])
        return halo.banded(
            lambda v, res: conv(v, w, scale, offset, relu=False, residual=res,
                                out_dtype=out_dtype, plain=plain),
            x, h_axis=h_axis(x), lo=lo, hi=hi, residual=residual)

    def train_forward(self, x: torch.Tensor,
                      plain: bool = False) -> torch.Tensor:
        """Differentiable stride-1 conv (+ bias) in x's dtype."""
        conv = conv3d_train if self.weight.dim() == 5 else conv2d_train
        y = conv(x, self.weight.to(x.dtype), plain=plain)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class ConvBNReLU(nn.Module):
    """Conv (no bias) + BN + ReLU, 2D or 3D (reference net/unit/base.py:7-69);
    padding (k-1)//2. Keys ``conv.weight``, ``bn.*``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, ndim: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = ConvND(in_ch, out_ch, kernel_size, ndim)
        self.bn = BatchNorm(out_ch)

    def folded(self, dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(weight in ``dtype``, scale, offset) for a fused kernel."""
        return (self.conv.weight.to(dtype),) + self.bn.fold()

    def forward(self, x: torch.Tensor, plain: bool = False,
                train: bool = False, vgroups: int = 1) -> torch.Tensor:
        w = self.conv.weight
        if train:
            conv = conv3d_train if w.dim() == 5 else conv2d_train
            y = conv(x, w.to(x.dtype), self.stride, plain=plain)
            return torch.relu(self.bn(y, train=True, vgroups=vgroups))
        conv = conv3d_bn_act if w.dim() == 5 else conv2d_bn_act
        folded = self.folded(x.dtype)
        lo, hi = halo.conv_halo(w.shape[-1], self.stride)
        return halo.banded(
            lambda v, _: conv(v, *folded, stride=self.stride, relu=True,
                              plain=plain),
            x, h_axis=h_axis(x), lo=lo, hi=hi, stride=self.stride)


class ConvTranspose3dWeight(nn.Module):
    """ConvTranspose3d(k3, s2, p1, output_padding 1, no bias) weight holder,
    torch layout (I, O, 3, 3, 3)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 3, 3, 3))


class ConvTranspose2dWeight(nn.Module):
    """ConvTranspose2d(k3, s2, p1, output_padding 1, no bias) weight holder,
    torch layout (I, O, 3, 3)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 3, 3))


def trconv2d_as_conv(x: torch.Tensor, weight: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """ConvTranspose2d(k3, stride 2, pad 1, output_padding 1) as a stride-1
    3x3 conv with padding 1: (x (N, H, W, C) with zeros between its pixels
    and after the last, (N, 2H, 2W, C); the flipped, transposed weight
    (O, I, 3, 3)). The transposed conv is the forward conv of the input
    dilated by 2 and padded (1, 2) with the flipped kernel; the trailing zero
    row and column make that padding the conv's symmetric 1."""
    n, h, w, c = x.shape
    z = x.new_zeros(n, h, 2, w, 2, c)
    z[:, :, 0, :, 0] = x
    return (z.reshape(n, 2 * h, 2 * w, c),
            weight.flip(-1, -2).transpose(0, 1))


class TrConvBNReLU2D(nn.Module):
    """ConvTranspose2d(k3, s2, p1, output_padding 1, no bias) + BN + ReLU
    (reference net/unit/base.py:28-47, RefineNet v1's depth upsampling);
    keys ``conv.weight`` (I, O, 3, 3), ``bn.*``. Runs as a stride-1 conv on
    the zero-interleaved input (:func:`trconv2d_as_conv`): K4 in eval, the
    differentiable conv (K8) in training."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ConvTranspose2dWeight(in_ch, out_ch)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, plain: bool = False,
                train: bool = False) -> torch.Tensor:
        z, w = trconv2d_as_conv(x, self.conv.weight.to(x.dtype))
        if train:
            y = conv2d_train(z, w, plain=plain)
            return torch.relu(self.bn(y, train=True))
        return conv2d_bn_act(z, w, *self.bn.fold(), relu=True, plain=plain)


def trconv_bn_relu(x: torch.Tensor, conv: ConvTranspose3dWeight,
                   bn: BatchNorm, *, residual=None, plain: bool = False,
                   train: bool = False) -> torch.Tensor:
    """ConvTranspose3d + BN + ReLU (+ skip add after the ReLU) — the 3D
    U-Nets' upsampling block (reference net/unit/regular.py:33-43). In
    train, the output is cropped on D to the skip before the add, as the
    JAX train path does (``regularize.py:251``)."""
    if train:
        y = trconv3d_train(x, conv.weight.to(x.dtype), plain=plain)
        y = torch.relu(bn(y, train=True))
        return y[:, :residual.shape[1]] + residual
    w, folded = conv.weight.to(x.dtype), bn.fold()
    # output rows 2i and 2i + 1 read input rows i and i + 1: one row below
    return halo.banded(
        lambda v, res: trconv3d_bn_act(v, w, *folded, relu=True,
                                       residual=res, plain=plain),
        x, h_axis=2, lo=0, hi=1, up=2, residual=residual)


class TrConvBNReLU3D(nn.Sequential):
    """Standalone upsampling block: keys ``0.weight`` (ConvTranspose3d),
    ``1.*`` (BN); ``2`` is the reference's parameter-free ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(ConvTranspose3dWeight(in_ch, out_ch),
                         BatchNorm(out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor, *, residual=None,
                plain: bool = False, train: bool = False) -> torch.Tensor:
        return trconv_bn_relu(x, self[0], self[1], residual=residual,
                              plain=plain, train=train)


class Res(nn.Module):
    """Residual block x + 0.1 * conv(relu(conv(x))) (reference
    net/unit/base.py:71-82); keys ``conv.0.weight``, ``conv.2.weight``.
    Runs inside RefineNet2's conv chain."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Sequential(ConvND(ch, ch, 3), nn.ReLU(),
                                  ConvND(ch, ch, 3))


def pixel_shuffle_2x(x: torch.Tensor) -> torch.Tensor:
    """PixelShuffle(2) on NHWC: (B, H, W, 4C) -> (B, 2H, 2W, C); the input
    channel index is c*4 + dy*2 + dx, as torch's on NCHW."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, 2 * h, 2 * w, c)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default initialisation from ``generator``: conv weights and
    biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = weight.size(1)
    * prod(kernel) (for a transposed conv that is the out channels, as in
    torch); BatchNorm weight 1, bias 0, running statistics (0, 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, (ConvND, ConvTranspose2dWeight,
                                ConvTranspose3dWeight)):
                w = m.weight
                bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
                w.uniform_(-bound, bound, generator=generator)
                bias = getattr(m, "bias", None)
                if bias is not None:
                    bias.uniform_(-bound, bound, generator=generator)
