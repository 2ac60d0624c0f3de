"""Convolutions with a fused folded-BN / bias epilogue (K2-K5, K10): CUDA
kernels and their plain PyTorch versions.

Ports of ``mdfnet_tpu/ops/pallas/conv3d_kernel.py`` (``conv3d_bn_relu`` K2,
``trconv3d_bn_relu`` K3, ``conv3d_pair_bn_relu`` K10) and
``mdfnet_tpu/ops/pallas/conv2d_kernel.py`` (``conv2d_fused`` K4,
``conv2d_chain_fused`` K5). All take channels-last
tensors (NHWC / NDHWC) and torch-layout weights, and compute

    y = relu?(conv(x) * scale[co] + offset[co]) (+ residual)

with f32 accumulation; folded eval BN is ``scale = gamma / sqrt(var + eps)``,
``offset = beta - mean * scale``; a plain bias is ``scale = 1, offset = bias``.

The chain (K5) runs its layers as consecutive launches of the K4 kernel, with
the Res blocks' 0.1 scale and skip adds in that kernel's epilogue; fusing the
chain in shared memory is later work. The pair (K10, ``csrc/conv3d_pair.cu``)
is two stride-1 conv3d layers in one launch whose intermediate volume stays
in shared memory; as in the JAX package, no model path runs it.

On the card a conv takes one of two kernels, by one static rule
(:func:`conv_route`): a bf16 conv with Ci and Co multiples of 8 (Co <= 64;
Co <= 32 for the transposed conv) runs on the tensor cores
(``csrc/conv_tc.cu``, an implicit GEMM on wgmma with the input tile and its
halo in shared memory, weights packed by :func:`pack_tc_weight`, or for the
transposed conv by :func:`pack_trconv_tc_weight`); every other conv, the
f32 ones, Co = 1 and Ci in {1, 3}, runs on the direct kernels of
``csrc/conv_bn_act.cu`` (f32 FMA on the CUDA cores). There is no fallback
between them: a launch that fails raises.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``plain=True`` asks for the plain version explicitly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mdfnet_tpu_torch.ops.cuda import build, exact_cuda_math

# kernel launches since the last reset (the main-path check reads them); the
# chain counts each of its layer launches. ``conv_tc`` counts the launches
# that took the tc route (csrc/conv_tc.cu), whichever wrapper made them; the
# wrapper's own counter counts them too. The ``*_dgrad`` counters are the
# launches that compute an input gradient for the training convolutions
# (ops/cuda/conv_vjp.py, which passes ``counter=``): K2 or K3 for
# conv3d_train, K2 at stride 2 for trconv3d_train, K4 for conv2d_train.
LAUNCHES = {"conv3d_bn_act": 0, "trconv3d_bn_act": 0, "conv2d_bn_act": 0,
            "conv2d_chain": 0, "conv3d_dgrad": 0, "trconv3d_dgrad": 0,
            "conv2d_dgrad": 0, "conv3d_pair_bn_act": 0, "conv_tc": 0}
# the tc-route launches among each wrapper counter's (their sum is
# LAUNCHES["conv_tc"])
TC_LAUNCHES = {k: 0 for k in LAUNCHES if k != "conv_tc"}
# None, or a list to which every conv launch appends (route, kd, k, stride,
# x's (N, D, H, W, Ci) shape, Co, transposed): what a run sends to which
# kernel
TRACE = None

_COB = 8                    # output channels per thread (csrc/conv_bn_act.cu)
_MAX_SMEM = 227 * 1024      # shared memory one block may use on the H100
_PAIR_MID_VOXELS = 4 * 10 * 18   # csrc/conv3d_pair.cu's tile with its halo
# csrc/conv_tc.cu: 64-row M blocks per warpgroup, by N (Co padded); the
# bytes of its table of K-step descriptors
_TC_MB = {8: 4, 16: 4, 32: 2, 64: 2}
_TC_TABLE = 1024
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


def _slots(k: int, stride: int) -> list[int]:
    """The tc kernel's order of kw within a kernel row: even kw first at
    stride 2, where the tile splits w by parity."""
    return list(range(k)) if stride == 1 else [*range(0, k, 2),
                                               *range(1, k, 2)]


@functools.lru_cache(maxsize=None)
def _slot_index(k: int, stride: int, device: torch.device) -> torch.Tensor:
    """:func:`_slots` as an index tensor on ``device``."""
    return torch.tensor(_slots(k, stride), device=device)


def pack_tc_weight(w_kio: torch.Tensor, *, kd: int, k: int,
                   stride: int) -> torch.Tensor:
    """(*taps, Ci, Co) weights as the tc kernel takes them: (kd*k*k*Ci/8,
    Co, 8) bf16, K chunk ((kd*k + kh)*Ci/8 + c)*k + slot holding input
    channels 8c..8c+7 of tap (kd, kh, _slots(k, stride)[slot]) for each
    output channel. One gather of ``w_kio`` in bf16: the kernel zero-fills
    the channels beyond Co and an odd count's last chunk itself."""
    ci, co = w_kio.shape[-2:]
    # (kd, kh, kw, c, j, co) -> (kd, kh, c, kw, co, j), views of w_kio
    src = w_kio.reshape(kd, k, k, ci // 8, 8, co).permute(0, 1, 3, 2, 5, 4)
    return torch.index_select(src.to(torch.bfloat16), 3, _slot_index(
        k, stride, w_kio.device)).view(-1, co, 8)


def conv_tc_plain(x, packed, scale, offset, *, kd, k, stride, relu,
                  residual, out_dtype):
    """Plain version of the tc kernel on its own operands: x (N, D, H, W, Ci)
    or (N, H, W, Ci) and the packed weights of :func:`pack_tc_weight`,
    consumed one K chunk at a time in the kernel's order, each an (M, 8) x
    (8, Co) product of the shifted, strided input, summed in f32; then the
    epilogue."""
    x5 = x if x.dim() == 5 else x[:, None]
    nb, di, hi, wi, ci = x5.shape
    nch, pd, p = ci // 8, kd // 2, k // 2
    do = -(-di // stride) if kd > 1 else di
    ho, wo = -(-hi // stride), -(-wi // stride)
    xp = F.pad(x5.float(), (0, 0, p, p, p, p, pd, pd))
    w = packed.float()
    acc = torch.zeros((nb, do, ho, wo, w.shape[1]), device=x.device)
    slots = _slots(k, stride)
    for q in range(kd * k * k * nch):
        slot, t = q % k, q // k
        c, t = t % nch, t // nch
        kh, kdd = t % k, t // k
        kw = slots[slot]
        patch = xp[:, kdd:kdd + stride * (do - 1) + 1:stride,
                   kh:kh + stride * (ho - 1) + 1:stride,
                   kw:kw + stride * (wo - 1) + 1:stride, 8 * c:8 * c + 8]
        acc += patch @ w[q].T
    y = acc * scale.float() + offset.float()
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + (residual if x.dim() == 5 else residual[:, None]).float()
    y = y.to(out_dtype)
    return y if x.dim() == 5 else y[:, 0]


# The transposed conv on the tc kernel (csrc/conv_tc.cu trconv_tc_kernel):
# four GEMMs over the input voxels, one per output parity pair (pd, ph),
# each with both w parities stacked on N = 2 Co.
_TR_PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _tr_tap(parity: int, offset: int) -> int:
    """The tap along one axis that output 2i + ``parity`` of the transposed
    conv takes from input i + ``offset``: 2i takes k = 1 from i, 2i + 1
    takes k = 2 from i and k = 0 from i + 1."""
    return 1 if parity == 0 else 2 - 2 * offset


def _tr_chunks() -> list[tuple[int, int, int, int]]:
    """The tc kernel's 18 K chunks per 8 input channels of the transposed
    conv, in its order: (GEMM p, input offsets od, oh, w offset ow), GEMM
    by GEMM, offsets (od, oh) in order, ow innermost."""
    return [(p, *divmod(t, ph + 1), ow)
            for p, (pd, ph) in enumerate(_TR_PAIRS)
            for t in range((pd + 1) * (ph + 1)) for ow in (0, 1)]


@functools.lru_cache(maxsize=None)
def _tr_tap_index(device: torch.device) -> torch.Tensor:
    """The taps kd*9 + kh*3 + kw of each chunk of :func:`_tr_chunks` for
    the even, then the odd w parity. The even one has none at w offset 1
    (the kernel zero-fills it): that entry repeats the odd one's."""
    taps = []
    for p, od, oh, ow in _tr_chunks():
        pd, ph = _TR_PAIRS[p]
        khd = _tr_tap(pd, od) * 9 + _tr_tap(ph, oh) * 3
        odd = khd + _tr_tap(1, ow)
        taps += [khd + 1 if ow == 0 else odd, odd]
    return torch.tensor(taps, device=device)


def pack_trconv_tc_weight(w_kio: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) transposed-conv weights as the tc kernel takes
    them: (Ci/8 * 18, 2 Co, 8) bf16, chunk 18c + j holding input channels
    8c..8c+7 of chunk j of :func:`_tr_chunks` for the even w parity's Co
    output channels, then the odd one's. One gather of ``w_kio`` in bf16."""
    ci, co = w_kio.shape[-2:]
    # (kd, kh, kw, c, j, co) -> (c, tap, co, j), views of w_kio
    src = w_kio.reshape(27, ci // 8, 8, co).permute(1, 0, 3, 2)
    return torch.index_select(src.to(torch.bfloat16), 1, _tr_tap_index(
        w_kio.device)).view(-1, 2 * co, 8)


def trconv_tc_plain(x, packed, scale, offset, *, relu, residual, out_dtype):
    """Plain version of the tc transposed conv on its own operands: x (N,
    D, H, W, Ci) and the packed weights of :func:`pack_trconv_tc_weight`,
    consumed GEMM by GEMM (output parities (pd, ph, 0) and (pd, ph, 1) at
    once) and K chunk by K chunk in the kernel's order, each an (M, 8) x
    (8, 2 Co) product of the input shifted by the chunk's offsets (zero
    past the far end), summed in f32; then the epilogue."""
    nb, di, hi, wi, ci = x.shape
    nch, co = ci // 8, packed.shape[1] // 2
    xp = F.pad(x.float(), (0, 0, 0, 1, 0, 1, 0, 1))
    chunks = _tr_chunks()
    w = packed.float().view(nch, len(chunks), 2 * co, 8).clone()
    for j, (_, _, _, ow) in enumerate(chunks):
        if ow:
            w[:, j, :co] = 0.0    # the even w parity's missing tap
    scale2, offset2 = scale.float().repeat(2), offset.float().repeat(2)
    y = torch.empty((nb, 2 * di, 2 * hi, 2 * wi, co), device=x.device)
    for p, (pd, ph) in enumerate(_TR_PAIRS):
        acc = torch.zeros((nb, di, hi, wi, 2 * co), device=x.device)
        for c in range(nch):
            for j, (q, od, oh, ow) in enumerate(chunks):
                if q == p:
                    acc += xp[:, od:od + di, oh:oh + hi, ow:ow + wi,
                              8 * c:8 * c + 8] @ w[c, j].T
        v = acc * scale2 + offset2
        if relu:
            v = torch.relu(v)
        # a row's 2 Co columns are fine w 2i and 2i + 1
        y[:, pd::2, ph::2] = v.view(nb, di, hi, 2 * wi, co)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


# ------------------------------------------------------------ the route

class TcPlan(NamedTuple):
    """The tc kernel's tile for one conv class (see :func:`tc_plan`)."""
    n: int          # Co padded to 8, 16, 32 or 64
    td: int         # output tile td x 8*bh x 8 voxels
    bh: int
    q: int          # K chunks of 8 input channels (even)
    q_stage: int    # K chunks per weight stage: q, or q / kd (transposed:
                    # the largest GEMM's, 8 Ci / 8)
    smem: int       # bytes of shared memory per block


@functools.lru_cache(maxsize=None)
def tc_plan(kd: int, k: int, stride: int, ci: int, co: int,
            transposed: bool = False, depth: int = 0,
            height: int = 0) -> TcPlan | None:
    """The tc kernel's tile for a conv, or None where it takes no such conv
    (Ci or Co not a multiple of 8, Co > 64; Co > 32 for the transposed
    conv) or no tile fits in shared memory.

    A block owns 2 * _TC_MB[n] M blocks of 8 x 8 output voxels (h, w),
    stacked along D as far as the input tile with its halo and the weights
    fit (``td`` x ``bh``), and holds the weights whole (``q_stage == q``) or
    one kd slab at a time; csrc/conv_tc.cu computes the same extents. The
    transposed conv (3x3x3, stride 2) tiles input voxels instead, see
    :func:`_trconv_tc_plan`; ``depth`` and ``height`` are its input's D and
    H."""
    if ci % 8 or co % 8 or not 0 < co <= 64 or ci <= 0:
        return None
    if transposed:
        return _trconv_tc_plan(ci, co, depth, height)
    n = next(v for v in _TC_MB if v >= co)
    nch = ci // 8
    q = kd * k * k * nch
    q += q % 2
    if q // 2 * 8 > _TC_TABLE:
        return None
    seg = stride * (8 + (k - 1) // stride)
    mblocks = 2 * _TC_MB[n]
    stages = [q] + ([q // kd] if kd > 1 and nch % 2 == 0 else [])
    for td in ([t for t in (8, 4, 2, 1) if t <= mblocks] if kd > 1 else [1]):
        bh = mblocks // td
        rows = ((stride * (td - 1) + kd) * (stride * (8 * bh - 1) + k)
                * nch * seg)
        for q_stage in stages:
            # the epilogue's f32 stage (64 rows of n + 8 per warpgroup)
            # reuses the tile's bytes
            smem = _TC_TABLE + max(16 * (rows + q_stage * n),
                                   2 * 64 * (n + 8) * 4)
            if smem <= _MAX_SMEM:
                return TcPlan(n, td, bh, q, q_stage, smem)
    return None


def _trconv_tc_plan(ci: int, co: int, depth: int,
                    height: int) -> TcPlan | None:
    """The transposed conv's tile: 2 * _TC_MB[n] M blocks of 8 x 8 input
    voxels, n = 2 Co padded (its w parities stacked on N); the input tile
    has a halo of one voxel at the far end. Of the ``td`` x ``bh`` whose
    tile fits, the one that pads ``depth`` x ``height`` least (the larger
    td on a tie; with both 0 the largest); the weights of the four GEMMs
    whole (``q_stage == q``) or one GEMM's at a time (``q_stage``: the
    largest GEMM's chunks)."""
    n = next((v for v in _TC_MB if v >= 2 * co), None)
    nch = ci // 8
    q = 18 * nch
    if n is None or q // 2 * 8 > _TC_TABLE:
        return None
    mblocks = 2 * _TC_MB[n]
    tds = [t for t in (8, 4, 2, 1) if t <= mblocks]
    # stable: ties keep the larger td first
    tds.sort(key=lambda t: -(-depth // t) * t
             * -(-height // (8 * mblocks // t)) * (8 * mblocks // t))
    for td in tds:
        bh = mblocks // td
        rows = (td + 1) * (8 * bh + 1) * nch * 9
        for q_stage in (q, 8 * nch):
            # the epilogue's f32 stage (64 rows of n + 8 per warpgroup)
            # has bytes of its own: the input tile serves all four GEMMs
            smem = (_TC_TABLE + 16 * (rows + q_stage * n)
                    + 2 * 64 * (n + 8) * 4)
            if smem <= _MAX_SMEM:
                return TcPlan(n, td, bh, q, q_stage, smem)
    return None


def conv_route(dtype: torch.dtype, kd: int, k: int, stride: int, ci: int,
               co: int, transposed: bool = False) -> str:
    """Which kernel a conv (``transposed``: the 3x3x3 stride-2 transposed
    conv) launches on the card: "tc" (csrc/conv_tc.cu, wgmma on the tensor
    cores) for a bf16 input with Ci % 8 == 0, Co % 8 == 0, Co <= 64 (32
    transposed) and a tile that fits in shared memory; "direct"
    (csrc/conv_bn_act.cu, f32 FMA) for the rest: f32, Co = 1 (ProbConv,
    refine's tail), Ci in {1, 3} (the trunk's and refine's heads)."""
    if dtype == torch.bfloat16 and tc_plan(kd, k, stride, ci, co,
                                           transposed):
        return "tc"
    return "direct"


# ------------------------------------------------------------ kernel launches

@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def trconv_tc_groups(tiles: int, sms: int) -> int:
    """Blocks per coarse tile of the tc transposed conv (1, 2 or 4, each
    running 4, 2 or 1 of its GEMMs): the fewest that give the launch two
    blocks per SM, so a small volume's launch is not one block's latency
    (a tile's input is then read once per block, mostly from L2)."""
    return next((g for g in (1, 2) if tiles * g >= 2 * sms), 4)


def _padded(v: torch.Tensor, cop: int) -> torch.Tensor:
    """Pad the last (output channel) axis to ``cop``, as contiguous f32."""
    v = v.float()
    return F.pad(v, (0, cop - v.shape[-1])).contiguous()


def _launch(counter, x5, w_kio, scale, offset, residual, out_dtype, *, kd, k,
            stride, relu, transposed=False, route=None):
    """Launch the conv (or transposed conv) kernel on (N, D, H, W, Ci) and
    count the launch under ``LAUNCHES[counter]`` (and ``"conv_tc"`` on the
    tc route).

    ``w_kio``: (*taps, Ci, Co) weights in any float dtype. ``route``: None
    follows :func:`conv_route`; "tc" or "direct" forces one."""
    n, di, hi, wi, ci = x5.shape
    co = w_kio.shape[-1]
    if (x5.dtype, out_dtype) not in _DTYPES:
        raise ValueError(f"conv kernel: unsupported dtypes {x5.dtype} -> "
                         f"{out_dtype}")
    if w_kio.shape[-2] != ci:
        raise ValueError(f"conv kernel: weight has {w_kio.shape[-2]} input "
                         f"channels, x has {ci}")
    if transposed:
        do, ho, wo = 2 * di, 2 * hi, 2 * wi
    else:
        do = -(-di // stride) if kd > 1 else di
        ho, wo = -(-hi // stride), -(-wi // stride)
    route = route or conv_route(x5.dtype, kd, k, stride, ci, co, transposed)
    y = torch.empty((n, do, ho, wo, co), dtype=out_dtype, device=x5.device)
    operands = [(x5, "x"), (y, "out")]
    if residual is not None:
        if residual.shape != y.shape or residual.dtype != out_dtype:
            raise ValueError(f"conv kernel: residual {tuple(residual.shape)} "
                             f"{residual.dtype} does not match the output "
                             f"{tuple(y.shape)} {out_dtype}")
        operands.append((residual, "residual"))
    if route == "tc":
        plan = tc_plan(kd, k, stride, ci, co, transposed,
                       *((di, hi) if transposed else (0, 0)))
        if plan is None or x5.dtype != torch.bfloat16:
            raise ValueError(f"conv tc kernel: no tile for {x5.dtype} kd={kd} "
                             f"k={k} stride={stride} Ci={ci} Co={co}"
                             f"{' (transposed)' if transposed else ''}")
        cop = plan.n
        w = (pack_trconv_tc_weight(w_kio) if transposed
             else pack_tc_weight(w_kio, kd=kd, k=k, stride=stride))
        # the kernel reads the first Co entries only
        s, o = scale.float().contiguous(), offset.float().contiguous()
    elif route == "direct":
        if 27 * ci * _COB * 4 > _MAX_SMEM:
            raise ValueError(f"conv kernel: Ci={ci} exceeds the shared "
                             "memory of the weight stage")
        cop = -(-co // _COB) * _COB
        w = _padded(w_kio.reshape(-1, co), cop)
        s, o = _padded(scale, cop), _padded(offset, cop)
    else:
        raise ValueError(f"conv kernel: unknown route {route!r}")
    operands += [(w, "weight"), (s, "scale"), (o, "offset")]
    for t, name in operands:
        build.check_operand(t, name)
    device, stream = build.launch_context(x5)
    lib = build.load_library()
    res_ptr = None if residual is None else residual.data_ptr()
    dtypes = _DTYPES[(x5.dtype, out_dtype)]
    ptrs = (x5.data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(), res_ptr,
            y.data_ptr())
    if route == "tc" and transposed:
        name = "trconv_tc"
        tiles = (n * -(-di // plan.td) * -(-hi // (8 * plan.bh))
                 * -(-wi // 8))
        err = lib.mdf_trconv_tc(*ptrs, n, di, hi, wi, ci, co, cop, int(relu),
                                plan.td, plan.bh,
                                trconv_tc_groups(tiles, _sm_count(device)),
                                int(plan.q_stage == plan.q), dtypes, device,
                                stream)
    elif route == "tc":
        name = "conv_tc"
        err = lib.mdf_conv_tc(
            *ptrs, n, di, hi, wi, ci, do, ho, wo, co, cop, kd, k, stride,
            int(relu), plan.td, plan.bh, plan.q, plan.q_stage, dtypes,
            device, stream)
    elif transposed:
        name = "trconv_bn_act"
        err = lib.mdf_trconv_bn_act(*ptrs, n, di, hi, wi, ci, co, cop,
                                    int(relu), dtypes, device, stream)
    else:
        name = "conv_bn_act"
        err = lib.mdf_conv_bn_act(*ptrs, n, di, hi, wi, ci, do, ho, wo, co,
                                  cop, kd, k, stride, int(relu), dtypes,
                                  device, stream)
    build.check(err, name)
    if route == "tc":
        LAUNCHES["conv_tc"] += 1
        TC_LAUNCHES[counter] += 1
    LAUNCHES[counter] += 1
    if TRACE is not None:
        TRACE.append((route, kd, k, stride, tuple(x5.shape), co, transposed))
    return y


def _conv2d_launch(counter, x, weight, scale, offset, *, stride, relu,
                   residual, out_dtype, route=None):
    k = weight.shape[-1]
    if k not in (1, 3, 5) or stride not in (1, 2):
        raise ValueError(f"conv2d kernel: k={k} stride={stride} unsupported")
    res = None if residual is None else residual[:, None]
    return _launch(counter, x[:, None], weight.permute(2, 3, 1, 0), scale,
                   offset, res, out_dtype, kd=1, k=k, stride=stride,
                   relu=relu, route=route)[:, 0]


# ------------------------------------------------------------ public wrappers

def conv2d_bn_act(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  offset: torch.Tensor, *, stride: int = 1, relu: bool = True,
                  residual: torch.Tensor | None = None, out_dtype=None,
                  plain: bool = False, counter: str = "conv2d_bn_act",
                  route: str | None = None) -> torch.Tensor:
    """2D conv (K4). x (N, H, W, Ci); weight (Co, Ci, k, k), k in {1, 3, 5};
    stride 1 or 2, padding (k-1)//2. Returns (N, ceil(H/s), ceil(W/s), Co)
    in ``out_dtype`` (default x.dtype). A launch counts under
    ``LAUNCHES[counter]``. ``route`` ("tc" or "direct") overrides
    :func:`conv_route`, to compare the two kernels."""
    out_dtype = out_dtype or x.dtype
    if plain or not x.is_cuda:
        return _conv_plain(x, weight, scale, offset, stride=stride, relu=relu,
                           residual=residual, out_dtype=out_dtype)
    return _conv2d_launch(counter, x, weight, scale, offset,
                          stride=stride, relu=relu, residual=residual,
                          out_dtype=out_dtype, route=route)


def conv3d_bn_act(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                  offset: torch.Tensor, *, stride: int = 1, relu: bool = True,
                  residual: torch.Tensor | None = None, out_dtype=None,
                  plain: bool = False, counter: str = "conv3d_bn_act",
                  route: str | None = None) -> torch.Tensor:
    """3x3x3 conv, pad 1, stride 1 or 2 (K2). x (N, D, H, W, Ci); weight
    (Co, Ci, 3, 3, 3). Returns (N, ceil(D/s), ceil(H/s), ceil(W/s), Co).
    ``route`` as in :func:`conv2d_bn_act`."""
    out_dtype = out_dtype or x.dtype
    if plain or not x.is_cuda:
        return _conv_plain(x, weight, scale, offset, stride=stride, relu=relu,
                           residual=residual, out_dtype=out_dtype)
    if tuple(weight.shape[2:]) != (3, 3, 3) or stride not in (1, 2):
        raise ValueError("conv3d kernel: 3x3x3 weights, stride 1 or 2 only")
    return _launch(counter, x, weight.permute(2, 3, 4, 1, 0), scale,
                   offset, residual, out_dtype, kd=3, k=3, stride=stride,
                   relu=relu, route=route)


def trconv3d_bn_act(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, offset: torch.Tensor, *,
                    relu: bool = True, residual: torch.Tensor | None = None,
                    out_dtype=None, plain: bool = False,
                    counter: str = "trconv3d_bn_act",
                    route: str | None = None) -> torch.Tensor:
    """ConvTranspose3d(k3, stride 2, pad 1, output_padding 1) (K3).
    x (N, D, H, W, Ci); weight (Ci, Co, 3, 3, 3), torch's layout. Returns
    (N, 2D, 2H, 2W, Co). ``route`` as in :func:`conv2d_bn_act`."""
    out_dtype = out_dtype or x.dtype
    if plain or not x.is_cuda:
        return _conv_plain(x, weight, scale, offset, stride=2, relu=relu,
                           residual=residual, out_dtype=out_dtype,
                           transposed=True)
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError("trconv3d kernel: 3x3x3 weights only")
    return _launch(counter, x, weight.permute(2, 3, 4, 0, 1), scale,
                   offset, residual, out_dtype, kd=3, k=3, stride=2,
                   relu=relu, transposed=True, route=route)


def conv3d_pair_bn_act_plain(x, w1, s1, o1, w2, s2, o2, *, relu=True):
    """Plain version of :func:`conv3d_pair_bn_act`: two chained plain
    conv3d + folded BN (+ ReLU), the intermediate rounded to x's dtype."""
    mid = _conv_plain(x, w1, s1, o1, stride=1, relu=relu, residual=None,
                      out_dtype=x.dtype)
    return _conv_plain(mid, w2, s2, o2, stride=1, relu=relu, residual=None,
                       out_dtype=x.dtype)


def conv3d_pair_bn_act(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                       o1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                       o2: torch.Tensor, *, relu: bool = True,
                       plain: bool = False) -> torch.Tensor:
    """Two chained stride-1 3x3x3 convs, pad 1, each with a folded BN and
    the ``relu`` flag, in one launch (K10); the intermediate never goes to
    device memory and is rounded to x's dtype, as in the JAX kernel.

    Args:
        x: (N, D, H, W, Ci), bf16 or f32.
        w1: (Cm, Ci, 3, 3, 3), Cm % 8 == 0 on CUDA; s1, o1: (Cm,).
        w2: (Co, Cm, 3, 3, 3); s2, o2: (Co,).
    Returns:
        (N, D, H, W, Co) in x's dtype.
    """
    if plain or not x.is_cuda:
        return conv3d_pair_bn_act_plain(x, w1, s1, o1, w2, s2, o2, relu=relu)
    n, d, h, w, ci = x.shape
    cm, co = w1.shape[0], w2.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3d pair kernel: unsupported dtype {x.dtype}")
    if tuple(w1.shape) != (cm, ci, 3, 3, 3) \
            or tuple(w2.shape) != (co, cm, 3, 3, 3):
        raise ValueError(f"conv3d pair kernel: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not chain from Ci={ci}")
    if cm % _COB:
        raise ValueError(f"conv3d pair kernel: Cm={cm} is not a multiple "
                         f"of {_COB}")
    cop = -(-co // _COB) * _COB
    elem = x.element_size()
    if _PAIR_MID_VOXELS * cm * elem > _MAX_SMEM:
        raise ValueError(f"conv3d pair kernel: Cm={cm} exceeds the shared "
                         "memory of the intermediate tile")
    w1k = w1.float().permute(2, 3, 4, 1, 0).reshape(27 * ci, cm).contiguous()
    w2k = _padded(w2.float().permute(2, 3, 4, 1, 0).reshape(27 * cm, co), cop)
    s1p, o1p = s1.float().contiguous(), o1.float().contiguous()
    s2p, o2p = _padded(s2, cop), _padded(o2, cop)
    y = torch.empty((n, d, h, w, co), dtype=x.dtype, device=x.device)
    for t, name in ((x, "x"), (w1k, "w1"), (s1p, "s1"), (o1p, "o1"),
                    (w2k, "w2"), (s2p, "s2"), (o2p, "o2"), (y, "out")):
        build.check_operand(t, name)
    device, stream = build.launch_context(x)
    lib = build.load_library()
    err = lib.mdf_conv3d_pair(
        x.data_ptr(), w1k.data_ptr(), s1p.data_ptr(), o1p.data_ptr(),
        w2k.data_ptr(), s2p.data_ptr(), o2p.data_ptr(), y.data_ptr(), n, d,
        h, w, ci, cm, co, cop, int(relu), _DTYPES[(x.dtype, x.dtype)],
        device, stream)
    build.check(err, "conv3d_pair")
    LAUNCHES["conv3d_pair_bn_act"] += 1
    return y


def conv2d_chain(x: torch.Tensor, weights, scales, offsets, *,
                 relu_flags: tuple = (), residuals: tuple | None = None,
                 final_stride: int = 1, plain: bool = False,
                 route: str | None = None) -> torch.Tensor:
    """A chain of 2D convs (K5), computing what ``conv2d_chain_fused`` does.

    Args:
        x: (N, H, W, Ci).
        weights: per-layer (Co, Ci, k, k) torch-layout weights.
        scales, offsets: per-layer (Co,) epilogues.
        relu_flags: per-layer ReLU (default: all True).
        residuals: per-layer ``None`` or an earlier layer index j: add layer
            j's output after this layer's ReLU (Res-block skips).
        final_stride: stride of the LAST layer (1 or 2); the others are 1.
        route: None follows :func:`conv_route` per layer; "direct" runs
            every layer on the direct kernel (to compare the two).
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
                               scales[layer], offsets[layer], route=route,
                               **kw)
        if layer in keep:
            kept[layer] = v
    return v
