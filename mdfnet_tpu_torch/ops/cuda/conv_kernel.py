"""Convolutions with a fused folded-BN / bias epilogue (K2-K5): CUDA kernels
and their plain PyTorch versions.

Ports of ``mdfnet_tpu/ops/pallas/conv3d_kernel.py`` (``conv3d_bn_relu`` K2,
``trconv3d_bn_relu`` K3) and ``mdfnet_tpu/ops/pallas/conv2d_kernel.py``
(``conv2d_fused`` K4, ``conv2d_chain_fused`` K5). All take channels-last
tensors (NHWC / NDHWC) and torch-layout weights, and compute

    y = relu?(conv(x) * scale[co] + offset[co]) (+ residual)

with f32 accumulation; folded eval BN is ``scale = gamma / sqrt(var + eps)``,
``offset = beta - mean * scale``; a plain bias is ``scale = 1, offset = bias``.

The chain (K5) runs its layers as consecutive launches of the K4 kernel, with
the Res blocks' 0.1 scale and skip adds in that kernel's epilogue; fusing the
chain in shared memory is later work.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``plain=True`` asks for the plain version explicitly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mdfnet_tpu_torch.ops.cuda import build, exact_cuda_math

# kernel launches since the last reset (the main-path check reads them); the
# chain counts each of its layer launches. The ``*_dgrad`` counters are the
# launches that compute an input gradient for the training convolutions
# (ops/cuda/conv_vjp.py, which passes ``counter=``): K2 or K3 for
# conv3d_train, K2 at stride 2 for trconv3d_train, K4 for conv2d_train.
LAUNCHES = {"conv3d_bn_act": 0, "trconv3d_bn_act": 0, "conv2d_bn_act": 0,
            "conv2d_chain": 0, "conv3d_dgrad": 0, "trconv3d_dgrad": 0,
            "conv2d_dgrad": 0}

_COB = 8                    # output channels per thread (csrc/conv_bn_act.cu)
_MAX_SMEM = 227 * 1024      # shared memory one block may use on the H100
_DTYPES = {(torch.float32, torch.float32): 0,
           (torch.bfloat16, torch.bfloat16): 1,
           (torch.bfloat16, torch.float32): 2}


# ------------------------------------------------------------ plain versions

def _conv_plain(x, weight, scale, offset, *, stride, relu, residual,
                out_dtype, transposed=False):
    """f32 reference on channels-last x; ``weight`` in torch layout."""
    if x.is_cuda:
        exact_cuda_math()
    xf = x.float().movedim(-1, 1)
    wf = weight.float()
    if transposed:
        y = F.conv_transpose3d(xf, wf, stride=2, padding=1, output_padding=1)
    else:
        conv = F.conv3d if x.dim() == 5 else F.conv2d
        y = conv(xf, wf, stride=stride, padding=weight.shape[-1] // 2)
    y = y.movedim(1, -1) * scale.float() + offset.float()
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


# ------------------------------------------------------------ kernel launches

def _padded(v: torch.Tensor, cop: int) -> torch.Tensor:
    """Pad the last (output channel) axis to ``cop``, as contiguous f32."""
    v = v.float()
    return F.pad(v, (0, cop - v.shape[-1])).contiguous()


def _launch(counter, x5, w_kio, scale, offset, residual, out_dtype, *, kd, k,
            stride, relu, transposed=False):
    """Launch the conv (or transposed conv) kernel on (N, D, H, W, Ci) and
    count the launch under ``LAUNCHES[counter]``.

    ``w_kio``: (*taps, Ci, Co) weights in any float dtype."""
    n, di, hi, wi, ci = x5.shape
    co = w_kio.shape[-1]
    cop = -(-co // _COB) * _COB
    if (x5.dtype, out_dtype) not in _DTYPES:
        raise ValueError(f"conv kernel: unsupported dtypes {x5.dtype} -> "
                         f"{out_dtype}")
    if w_kio.shape[-2] != ci:
        raise ValueError(f"conv kernel: weight has {w_kio.shape[-2]} input "
                         f"channels, x has {ci}")
    if 27 * ci * _COB * 4 > _MAX_SMEM:
        raise ValueError(f"conv kernel: Ci={ci} exceeds the shared memory of "
                         "the weight stage")
    if transposed:
        do, ho, wo = 2 * di, 2 * hi, 2 * wi
    else:
        do = -(-di // stride) if kd > 1 else di
        ho, wo = -(-hi // stride), -(-wi // stride)
    w = _padded(w_kio.reshape(-1, co), cop)
    s, o = _padded(scale, cop), _padded(offset, cop)
    y = torch.empty((n, do, ho, wo, co), dtype=out_dtype, device=x5.device)
    operands = [(x5, "x"), (w, "weight"), (s, "scale"), (o, "offset"),
                (y, "out")]
    if residual is not None:
        if residual.shape != y.shape or residual.dtype != out_dtype:
            raise ValueError(f"conv kernel: residual {tuple(residual.shape)} "
                             f"{residual.dtype} does not match the output "
                             f"{tuple(y.shape)} {out_dtype}")
        operands.append((residual, "residual"))
    for t, name in operands:
        build.check_operand(t, name)
    device, stream = build.launch_context(x5)
    lib = build.load_library()
    res_ptr = None if residual is None else residual.data_ptr()
    dtypes = _DTYPES[(x5.dtype, out_dtype)]
    if transposed:
        err = lib.mdf_trconv_bn_act(
            x5.data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(), res_ptr,
            y.data_ptr(), n, di, hi, wi, ci, co, cop, int(relu), dtypes,
            device, stream)
    else:
        err = lib.mdf_conv_bn_act(
            x5.data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(), res_ptr,
            y.data_ptr(), n, di, hi, wi, ci, do, ho, wo, co, cop, kd, k,
            stride, int(relu), dtypes, device, stream)
    build.check(err, "trconv_bn_act" if transposed else "conv_bn_act")
    LAUNCHES[counter] += 1
    return y


def _conv2d_launch(counter, x, weight, scale, offset, *, stride, relu,
                   residual, out_dtype):
    k = weight.shape[-1]
    if k not in (1, 3, 5) or stride not in (1, 2):
        raise ValueError(f"conv2d kernel: k={k} stride={stride} unsupported")
    res = None if residual is None else residual[:, None]
    return _launch(counter, x[:, None], weight.permute(2, 3, 1, 0), scale,
                   offset, res, out_dtype, kd=1, k=k, stride=stride,
                   relu=relu)[:, 0]


# ------------------------------------------------------------ public wrappers

def conv2d_bn_act(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  offset: torch.Tensor, *, stride: int = 1, relu: bool = True,
                  residual: torch.Tensor | None = None, out_dtype=None,
                  plain: bool = False,
                  counter: str = "conv2d_bn_act") -> torch.Tensor:
    """2D conv (K4). x (N, H, W, Ci); weight (Co, Ci, k, k), k in {1, 3, 5};
    stride 1 or 2, padding (k-1)//2. Returns (N, ceil(H/s), ceil(W/s), Co)
    in ``out_dtype`` (default x.dtype). A launch counts under
    ``LAUNCHES[counter]``."""
    out_dtype = out_dtype or x.dtype
    if plain or not x.is_cuda:
        return _conv_plain(x, weight, scale, offset, stride=stride, relu=relu,
                           residual=residual, out_dtype=out_dtype)
    return _conv2d_launch(counter, x, weight, scale, offset,
                          stride=stride, relu=relu, residual=residual,
                          out_dtype=out_dtype)


def conv3d_bn_act(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  offset: torch.Tensor, *, stride: int = 1, relu: bool = True,
                  residual: torch.Tensor | None = None, out_dtype=None,
                  plain: bool = False,
                  counter: str = "conv3d_bn_act") -> torch.Tensor:
    """3x3x3 conv, pad 1, stride 1 or 2 (K2). x (N, D, H, W, Ci); weight
    (Co, Ci, 3, 3, 3). Returns (N, ceil(D/s), ceil(H/s), ceil(W/s), Co)."""
    out_dtype = out_dtype or x.dtype
    if plain or not x.is_cuda:
        return _conv_plain(x, weight, scale, offset, stride=stride, relu=relu,
                           residual=residual, out_dtype=out_dtype)
    if tuple(weight.shape[2:]) != (3, 3, 3) or stride not in (1, 2):
        raise ValueError("conv3d kernel: 3x3x3 weights, stride 1 or 2 only")
    return _launch(counter, x, weight.permute(2, 3, 4, 1, 0), scale,
                   offset, residual, out_dtype, kd=3, k=3, stride=stride,
                   relu=relu)


def trconv3d_bn_act(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, offset: torch.Tensor, *,
                    relu: bool = True, residual: torch.Tensor | None = None,
                    out_dtype=None, plain: bool = False,
                    counter: str = "trconv3d_bn_act") -> torch.Tensor:
    """ConvTranspose3d(k3, stride 2, pad 1, output_padding 1) (K3).
    x (N, D, H, W, Ci); weight (Ci, Co, 3, 3, 3), torch's layout. Returns
    (N, 2D, 2H, 2W, Co)."""
    out_dtype = out_dtype or x.dtype
    if plain or not x.is_cuda:
        return _conv_plain(x, weight, scale, offset, stride=2, relu=relu,
                           residual=residual, out_dtype=out_dtype,
                           transposed=True)
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError("trconv3d kernel: 3x3x3 weights only")
    return _launch(counter, x, weight.permute(2, 3, 4, 0, 1), scale,
                   offset, residual, out_dtype, kd=3, k=3, stride=2,
                   relu=relu, transposed=True)


def conv2d_chain(x: torch.Tensor, weights, scales, offsets, *,
                 relu_flags: tuple = (), residuals: tuple | None = None,
                 final_stride: int = 1, plain: bool = False) -> torch.Tensor:
    """A chain of 2D convs (K5), computing what ``conv2d_chain_fused`` does.

    Args:
        x: (N, H, W, Ci).
        weights: per-layer (Co, Ci, k, k) torch-layout weights.
        scales, offsets: per-layer (Co,) epilogues.
        relu_flags: per-layer ReLU (default: all True).
        residuals: per-layer ``None`` or an earlier layer index j: add layer
            j's output after this layer's ReLU (Res-block skips).
        final_stride: stride of the LAST layer (1 or 2); the others are 1.
    Returns:
        The last layer's output, in x's dtype.
    """
    nlayers = len(weights)
    relu_flags = relu_flags or (True,) * nlayers
    residuals = residuals or (None,) * nlayers
    if not (len(relu_flags) == len(residuals) == nlayers):
        raise ValueError("conv2d_chain: per-layer lists differ in length")
    keep = {j for j in residuals if j is not None}
    kept, v = {}, x
    for layer in range(nlayers):
        stride = final_stride if layer == nlayers - 1 else 1
        res = kept[residuals[layer]] if residuals[layer] is not None else None
        kw = dict(stride=stride, relu=relu_flags[layer], residual=res,
                  out_dtype=x.dtype)
        if plain or not x.is_cuda:
            v = _conv_plain(v, weights[layer], scales[layer], offsets[layer],
                            **kw)
        else:
            v = _conv2d_launch("conv2d_chain", v, weights[layer],
                               scales[layer], offsets[layer], **kw)
        if layer in keep:
            kept[layer] = v
    return v
