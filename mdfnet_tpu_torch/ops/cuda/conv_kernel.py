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

The chain (K5) runs by a static rule (:func:`chain_route`) either on the
chain kernel (``csrc/conv_chain.cu``: each launch several layers, each
layer's output kept in shared memory for the next as a wgmma A tile, the
halo recomputed at the tile edges, a Ci = 1 or 3 head gathered into a
packed K = 16 / 48 GEMM; launches planned by :func:`chain_plan` at the
chain's tile in CHAIN_FUSED), or as consecutive launches of the K4
kernels, one per layer, with the Res blocks' 0.1 scale and skip adds in
the epilogue. The pair (K10, ``csrc/conv3d_pair.cu``) is two stride-1 conv3d
layers in one launch whose intermediate volume stays in shared memory (bf16:
a block walks D on wgmma with rings of input and intermediate planes,
:func:`pair_plan`; f32 and odd channel counts: the CUDA cores); as in the
JAX package, no model path runs it.

On the card a conv takes one of three kernels, by one static rule
(:func:`conv_route`): a bf16 conv with Ci and Co multiples of 8 (Co <= 64;
Co <= 32 for the transposed conv) runs on the tensor cores
(``csrc/conv_tc.cu``, an implicit GEMM on wgmma with the input tile and its
halo in shared memory, weights packed by :func:`pack_tc_weight`, or for the
transposed conv by :func:`pack_trconv_tc_weight`); a 3x3(x3) stride-1 conv
to Co = 1 with Ci a multiple of 8 (the ProbConvs, refine's tail), bf16 or
f32, on ``csrc/conv_co1.cu`` (a per-voxel reduction over a shared-memory
tile, :func:`co1_plan`); every other conv, the f32 ones with Co > 1 and Ci
in {1, 3}, runs on the direct kernels of ``csrc/conv_bn_act.cu`` (f32 FMA
on the CUDA cores). There is no fallback between them: a launch that fails
raises. The transposed conv's input gradient in training asks
:func:`stream_route` instead, which sends the launches that the tc kernel's
resident tile would starve to ``csrc/conv_stream.cu`` (K streamed through
a ring of stages, no halo tile) and the rest to :func:`conv_route`'s
kernel.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``plain=True`` asks for the plain version explicitly.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mdfnet_tpu_torch.ops.cuda import build, exact_cuda_math
from mdfnet_tpu_torch.utils import tracing

# kernel launches since the last reset (the main-path check reads them);
# ``conv2d_chain`` counts the chain kernel's launches (csrc/conv_chain.cu,
# one per segment), while a chain on the per-layer route counts its layers
# under ``conv2d_bn_act``. ``conv_tc`` counts the launches
# that took the tc route (csrc/conv_tc.cu), ``conv_co1`` those that took the
# co1 route (csrc/conv_co1.cu), whichever wrapper made them; the wrapper's
# own counter counts them too. The ``*_dgrad`` counters are the
# launches that compute an input gradient for the training convolutions
# (ops/cuda/conv_vjp.py, which passes ``counter=``): K2 or K3 for
# conv3d_train, K2 at stride 2 for trconv3d_train, K4 for conv2d_train.
LAUNCHES = {"conv3d_bn_act": 0, "trconv3d_bn_act": 0, "conv2d_bn_act": 0,
            "conv2d_chain": 0, "conv3d_dgrad": 0, "trconv3d_dgrad": 0,
            "conv2d_dgrad": 0, "conv3d_pair_bn_act": 0, "conv_tc": 0,
            "conv_co1": 0, "conv_stream": 0}
# the tc-route launches among each conv wrapper counter's (their sum is
# LAUNCHES["conv_tc"]; the chain and stream kernels are routes of their own)
TC_LAUNCHES = {k: 0 for k in LAUNCHES
               if k not in ("conv_tc", "conv_co1", "conv2d_chain",
                            "conv_stream")}
# None, or a list to which every conv launch appends (route, kd, k, stride,
# x's (N, D, H, W, Ci) shape, Co, transposed): what a run sends to which
# kernel
TRACE = None

_COB = 8                    # output channels per thread (csrc/conv_bn_act.cu)
_MAX_SMEM = 227 * 1024      # shared memory one block may use on the H100
_SM_SMEM = 228 * 1024       # an SM's, shared by its blocks (1 KB a block)
# csrc/conv_tc.cu: 64-row M blocks per warpgroup, by N (Co padded); the
# bytes of its table of K-step descriptors
_TC_MB = {8: 4, 16: 4, 32: 2, 64: 2}
_TC_TABLE = 1024
# csrc/conv_co1.cu: threads per block, tile width (w), outputs per thread
# (along w), 16-byte words per staged row of the tile
_CO1_THREADS, _CO1_TW, _CO1_COLS, _CO1_ROW = 256, 32, 4, 36
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


def two_per_sm(smem: int) -> bool:
    """Whether two blocks of ``smem`` bytes of shared memory fit on an SM."""
    return 2 * (smem + 1024) <= _SM_SMEM


# csrc/conv3d_pair.cu. The CUDA-core body: one thread an output voxel of a
# 2 x 8 x 16 tile, the intermediate tile with its one-voxel halo (4 x 10 x
# 18) in shared memory. The tensor-core body: the 64-row M blocks a conv
# may have, by N (what a block's four warpgroups hold at once: two each at
# N = 16 and 32, one at 64, 128 registers a thread); the tiles, input rings
# and taps per weight stage that pair_plan weighs; a shared-memory row is
# 16 bytes.
_PAIR_DIRECT_TILE, _PAIR_DIRECT_MID = (2, 8, 16), 4 * 10 * 18
_PAIR_BLOCKS = {16: 8, 32: 8, 64: 4}
_PAIR_TILES = ((16, 16), (16, 8), (8, 16), (8, 8), (16, 32), (8, 32))
_PAIR_RINGS = (4, 3)
_PAIR_STAGES = (27, 9, 3)
# pair_plan's cost of one byte of weights that a block streams through
# shared memory in its MACs: the tensor cores do ~2048 MACs a clock on an
# SM, a block's copies from L2 move ~64 bytes
_PAIR_BYTE_MACS = 32


class PairPlan(NamedTuple):
    """How csrc/conv3d_pair.cu runs a pair (see :func:`pair_plan`)."""
    route: str      # "tc": wgmma, D streamed; "direct": CUDA-core f32 FMA
    th: int         # output tile th x tw (h, w) a block
    tw: int
    planes: int     # output planes a block walks along D (tc)
    ring: int       # input planes held in shared memory, 3 or 4 (tc)
    taps: int       # taps per weight stage; 27: both convs' held whole (tc)
    pitch: int      # positions a row of a plane buffer: tw + 4 (tc)
    mblocks: tuple  # 64-row M blocks of the first and second conv (tc)
    rows: tuple     # 16-byte rows a channel chunk of an input and an
                    # intermediate plane (tc)
    smem: int       # bytes of shared memory a block
    grid: tuple     # blocks along w, h, and N x D segments


def pair_geometry(th: int, tw: int, ci: int, cm: int, co: int, ring: int,
                  taps: int) -> tuple[int, int, int, int, int, int]:
    """The tensor-core pair's extents for a th x tw tile, as
    csrc/conv3d_pair.cu computes them: (pitch, M blocks of the first and
    second conv, rows of an input and an intermediate plane's channel
    chunk, shared-memory bytes).

    Every plane buffer flattens (h, w) with the pitch p = tw + 4 (the input
    plane's width), so a GEMM row is a position and a tap (kh, kw) one
    shift of kh p + kw rows. The first conv computes the intermediate over
    the tile and its one-voxel halo, (th + 2) p rows, the second the
    output, th p rows; the columns past the region are computed and left.
    A chunk's rows hold the plane and what the last M block's taps read
    past it; an odd count spreads the chunks over the banks. Before the
    rings, two tables of the K steps' A descriptors (8 bytes a step of
    either conv, to 128 bytes)."""
    p = tw + 4
    nb1, nb2 = -(-(th + 2) * p // 64), -(-th * p // 64)
    npx = max((th + 4) * p, 64 * nb1 + 2 * p + 2) | 1
    npm = max(64 * nb1, 64 * nb2 + 2 * p + 2) | 1
    nchx, nchm = ci // 8, cm // 8
    tables = -(-16 * 27 * (nchx + nchm) // 2 // 128) * 128
    wrows = (27 * (nchx * cm + nchm * co) if taps == 27
             else taps * max(nchx * cm, nchm * co))
    return p, nb1, nb2, npx, npm, tables + 16 * (
        ring * nchx * npx + 3 * nchm * npm + wrows)


@functools.lru_cache(maxsize=None)
def pair_plan(dtype: torch.dtype, n: int, d: int, h: int, w: int, ci: int,
              cm: int, co: int, sms: int = 132) -> PairPlan | None:
    """How csrc/conv3d_pair.cu runs the pair Ci -> Cm -> Co on an (n, d, h,
    w) volume on a card of ``sms`` SMs, or None where it takes no such
    pair (Cm not a multiple of 8, or its intermediate tile too large).

    bf16 with Ci % 16 == 0 and Cm, Co in {16, 32, 64} runs on the tensor
    cores ("tc"): a block of four warpgroups owns a th x tw column of the
    output and walks ``planes`` planes along D, each plane's intermediate
    computed once into a ring of three (one-voxel H/W halo) from a ring of
    ``ring`` input planes (two-voxel halo), the next input plane copied
    while the current one computes, the weights held whole or streamed
    ``taps`` taps a stage. Of the plans whose M blocks fit a warpgroup's
    registers (:data:`_PAIR_BLOCKS`) and whose shared memory fits, the one of
    least cost: the waves of blocks on the SMs times a block's work, its
    MACs (the recomputed halo rows and the edge planes of a D segment
    included) and the weight bytes it streams (:data:`_PAIR_BYTE_MACS`);
    on a tie the longer walk, the larger weight stage, ring and tile.
    Everything else ("direct": f32, Ci = 3, Cm = 8 ...) runs on the CUDA
    cores."""
    if dtype == torch.bfloat16 and ci % 16 == 0 and cm in _PAIR_BLOCKS \
            and co in _PAIR_BLOCKS:
        best = None
        for th, tw in _PAIR_TILES:
            tiles = n * -(-h // th) * -(-w // tw)
            for ring in _PAIR_RINGS:
                for taps in _PAIR_STAGES:
                    p, nb1, nb2, npx, npm, smem = pair_geometry(
                        th, tw, ci, cm, co, ring, taps)
                    if (nb1 > _PAIR_BLOCKS[cm] or nb2 > _PAIR_BLOCKS[co]
                            or smem > _MAX_SMEM or max(npx, npm) > 0x3FFF):
                        continue
                    per_sm = 2 if two_per_sm(smem) else 1
                    for segs in range(1, d + 1):
                        planes = -(-d // segs)
                        if -(-d // planes) != segs:
                            continue    # the same walk as fewer segments
                        macs = 27 * ((planes + 2) * nb1 * 64 * ci * cm
                                     + planes * nb2 * 64 * cm * co)
                        if taps < 27:
                            macs += _PAIR_BYTE_MACS * 2 * 27 * (
                                (planes + 2) * ci * cm + planes * cm * co)
                        waves = -(-tiles * segs // (sms * per_sm))
                        key = (waves * per_sm * macs, -planes, -taps,
                               -ring, -th * tw)
                        if best is None or key < best[0]:
                            best = (key, PairPlan(
                                "tc", th, tw, planes, ring, taps, p,
                                (nb1, nb2), (npx, npm), smem,
                                (-(-w // tw), -(-h // th), n * segs)))
        if best:
            return best[1]
    smem = _PAIR_DIRECT_MID * cm * dtype.itemsize
    if cm % _COB or smem > _MAX_SMEM:
        return None
    td, th, tw = _PAIR_DIRECT_TILE
    return PairPlan("direct", th, tw, td, 0, 0, 0, (), (), smem,
                    (-(-w // tw), -(-h // th), n * -(-d // td)))


# csrc/conv_stream.cu: the stages in its ring (kStages there)
_STREAM_STAGES = 3


class StreamPlan(NamedTuple):
    """How csrc/conv_stream.cu runs a conv (see :func:`stream_plan`)."""
    n: int          # Co padded to 16, 32 or 64
    chunks: int     # K chunks of 8 input channels a stage
    smem: int       # bytes of shared memory a block


def stream_plan(ci: int, co: int) -> StreamPlan | None:
    """csrc/conv_stream.cu's plan for a 3x3x3 conv from Ci to Co channels,
    or None where it takes none (Ci or Co not a multiple of 8, Co > 64).
    One warpgroup owns 64 consecutive output voxels and the whole Co; K
    (the taps x 8-channel chunks, in that order) streams through a ring of
    _STREAM_STAGES stages of ``chunks`` chunks (four taps', at most 32: a
    divisor of the block's 128 threads), A gathered per output row beside
    the weights' slice. The shared memory holds the rows' input origins
    and the ring."""
    if ci <= 0 or ci % 8 or co % 8 or not 0 < co <= 64:
        return None
    n = next(v for v in (16, 32, 64) if v >= co)
    chunks = min(4 * (ci // 8), 32)
    smem = 16 * (64 + _STREAM_STAGES * chunks * (65 + n))
    return StreamPlan(n, chunks, smem) if smem <= _MAX_SMEM else None


def stream_route(dtype: torch.dtype, kd: int, k: int, stride: int, ci: int,
                 co: int, shape: tuple, sms: int) -> str:
    """The route of a conv that may take csrc/conv_stream.cu (its caller:
    the transposed conv's input gradient, conv_vjp.py): "stream" for a bf16
    3x3x3 stride-2 conv where the tc kernel's resident tile
    (:func:`tc_plan`) lets one block only on an SM and its grid leaves SMs
    idle (fewer blocks than ``sms``), so that its loads have nothing to
    hide behind; else :func:`conv_route`'s. ``shape``: the input's (N, D,
    H, W). From shapes and the SM count alone."""
    plan = tc_plan(kd, k, stride, ci, co)
    if (dtype == torch.bfloat16 and (kd, k, stride) == (3, 3, 2) and plan
            and not two_per_sm(plan.smem)):
        nb, di, hi, wi = shape
        do, ho, wo = -(-di // 2), -(-hi // 2), -(-wi // 2)
        blocks = (-(-wo // 8) * -(-ho // (8 * plan.bh)) * nb
                  * -(-do // plan.td))
        if blocks < sms and stream_plan(ci, co):
            return "stream"
    return conv_route(dtype, kd, k, stride, ci, co)


def pack_tap_weight(w_kio: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) weights as the pair's tensor-core body and the
    stream kernel take them: (27 Ci/8, Co, 8) bf16, K chunk tap * Ci/8 + c
    (tap = (kd*3 + kh)*3 + kw) holding input channels 8c..8c+7 for each
    output channel."""
    ci, co = w_kio.shape[-2:]
    return w_kio.to(torch.bfloat16).reshape(27, ci // 8, 8, co) \
        .permute(0, 1, 3, 2).contiguous().view(-1, co, 8)


class Co1Plan(NamedTuple):
    """The Co = 1 kernel's tile for one conv class (see :func:`co1_plan`)."""
    td: int         # output tile td x th x tw voxels
    th: int
    tw: int
    channels: int   # input channels per stage (a multiple of 8 dividing Ci)
    smem: int       # bytes of shared memory per block


@functools.lru_cache(maxsize=None)
def co1_plan(kd: int, ci: int, itemsize: int) -> Co1Plan | None:
    """csrc/conv_co1.cu's tile for a KD x 3 x 3 stride-1 conv to Co = 1
    from Ci channels of ``itemsize`` bytes, or None where it takes none (Ci
    not a multiple of 8, KD not 1 or 3). 256 threads own td x th x 32
    outputs, 4 along w each (KD = 3: 4 x 8 x 32; KD = 1: 1 x 32 x 32); the
    block holds the weights (f32) and the tile's input with its one-voxel
    halo (rows of 34 voxels padded to 36) for 16 channels at a time where
    16 divides Ci, else 8. With Ci <= 16 (one stage) the kernel sums in the
    direct kernel's order and gives its bits."""
    if ci <= 0 or ci % 8 or kd not in (1, 3):
        return None
    td = 4 if kd == 3 else 1
    th = _CO1_THREADS // (_CO1_TW // _CO1_COLS) // td
    cs = 16 if ci % 16 == 0 else 8
    words = (td + kd - 1) * (th + 2) * _CO1_ROW
    smem = -(-kd * 9 * ci * 4 // 16) * 16 + words * cs * itemsize
    return Co1Plan(td, th, _CO1_TW, cs, smem) if smem <= _MAX_SMEM else None


# csrc/conv_chain.cu: the most layers of one launch, the largest N of a
# layer, the M blocks a warpgroup takes per pass (kMB), the ints of its
# plan's header and of each layer's record (ChainPlan, ChainLayer there);
# a launch's shared memory holds its plan's ints (to 128 bytes), the table
# of K-step descriptors, the weights, then the buffers
_CHAIN_MAX_LAYERS, _CHAIN_MAX_N, _CHAIN_MB = 12, 32, 2
_CHAIN_HEADER, _CHAIN_LAYER = 18, 35
# the most shared memory a launch of the chain kernel takes a block: two
# blocks share an SM (its 228 KB, less 1 KB a block); a block that takes
# more runs alone on its SM, which loses more than a smaller tile's halo
# costs (PERF.md section 6)
_CHAIN_SMEM = 113 * 1024

def _ceil8(v: int) -> int:
    return -(-v // 8) * 8


def chain_outputs(stride: int, co: int) -> int:
    """Outputs along w that one GEMM row of the chain kernel computes for a
    layer: 2 for a stride-1 layer to 8 channels (N = 16: the two outputs'
    channels side by side, from a window of k + 1 input columns), else 1."""
    return 2 if stride == 1 and co == 8 else 1


def head_chunks(k: int, ci: int, p: int = 1) -> int:
    """K chunks (of 8) of a chain's packed head, k rows x (k + p - 1)
    window columns x Ci channels (Ci = 1 or 3, p outputs a row): the
    values padded to a whole, even number."""
    q = -(-k * (k + p - 1) * ci // 8)
    return q + q % 2


def _window_weight(weight: torch.Tensor, p: int) -> torch.Tensor:
    """(Co, Ci, k, k) -> (k, k + p - 1, Ci, p * Co): the weight of window
    column kw' for output pp (kw' - pp the tap, zero outside the taps)."""
    co, ci, k, _ = weight.shape
    full = weight.new_zeros((k, k + p - 1, ci, p, co))
    for pp in range(p):
        full[:, pp:pp + k, :, pp] = weight.permute(2, 3, 1, 0)
    return full.reshape(k, k + p - 1, ci, p * co)


def pack_head_weight(weight: torch.Tensor, p: int = 1) -> torch.Tensor:
    """(Co, Ci, k, k) weights of a chain's head (Ci = 1 or 3) as
    csrc/conv_chain.cu takes them: (head_chunks, p * Co, 8) bf16, K value
    8q + j = (kh * (k + p - 1) + kw') * Ci + c of a row's window, column
    pp * Co + co for its pp-th output (:func:`_window_weight`), zero past
    the window's values."""
    co, ci, k, _ = weight.shape
    taps = _window_weight(weight, p).reshape(-1, p * co)
    q = head_chunks(k, ci, p)
    taps = F.pad(taps.to(torch.bfloat16), (0, 0, 0, 8 * q - taps.shape[0]))
    return taps.view(q, 8, p * co).permute(0, 2, 1).contiguous()


def pack_chain_weight(weight: torch.Tensor, *, stride: int,
                      p: int = 1) -> torch.Tensor:
    """(Co, Ci, k, k) weights (Ci % 8 == 0) of a chain layer that reads a
    buffer, as csrc/conv_chain.cu takes them: (k * Ci/8 * (k + p - 1),
    p * Co, 8) bf16, chunk (kh * Ci/8 + c) * (k + p - 1) + slot holding
    input channels 8c .. 8c + 7 of window column _slots(k + p - 1, 2)
    [slot] (even columns first where the input splits w by parity: stride
    2 or p = 2), columns as :func:`pack_head_weight`'s. With p = 1 it is
    :func:`pack_tc_weight`'s order."""
    co, ci, k, _ = weight.shape
    nslot = k + p - 1
    # (kh, kw', c, j, col) -> (kh, c, kw', col, j)
    src = _window_weight(weight, p).reshape(k, nslot, ci // 8, 8, p * co) \
        .permute(0, 2, 1, 4, 3)
    order = _slot_index(nslot, 2 if stride * p == 2 else 1, weight.device)
    return torch.index_select(src.to(torch.bfloat16), 2, order) \
        .reshape(-1, p * co, 8)


def chain_head_plain(x, packed, scale, offset, *, k, stride, relu,
                     out_dtype, p=1):
    """Plain version of the chain kernel's head on its own operands: x (N,
    H, W, Ci), Ci = 1 or 3, gathered per group of p outputs along w into
    the packed K order of :func:`pack_head_weight` (k rows x (k + p - 1)
    window columns x Ci, zero-padded to 16 x chunks) and multiplied by the
    packed weights in K steps of 16, summed in f32; then the epilogue."""
    nb, hi, wi, ci = x.shape
    pad, nslot = k // 2, k + p - 1
    ho, wo = -(-hi // stride), -(-wi // stride)
    g = -(-wo // p)
    xp = F.pad(x.float(), (0, 0, pad, pad + stride * p * g, pad, pad))
    cols = torch.cat([xp[:, kh:kh + stride * (ho - 1) + 1:stride,
                         kw:kw + stride * p * (g - 1) + 1:stride * p]
                      for kh in range(k) for kw in range(nslot)], -1)
    w = packed.float()
    q = w.shape[0]
    cols = F.pad(cols, (0, 8 * q - cols.shape[-1]))
    acc = torch.zeros((nb, ho, g, w.shape[1]), device=x.device)
    for s in range(q // 2):
        acc += cols[..., 16 * s:16 * s + 16] @ w[2 * s:2 * s + 2] \
            .permute(0, 2, 1).reshape(16, -1)
    acc = acc.reshape(nb, ho, g * p, -1)[:, :, :wo]
    y = acc * scale.float() + offset.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


class ChainSegment(NamedTuple):
    """One launch of the chain kernel: layers ``first`` .. ``last`` of the
    chain over final tiles of ``th`` x ``tw`` outputs."""
    first: int
    last: int
    th: int
    tw: int
    smem: int       # bytes of shared memory per block
    regions: tuple  # per layer: (h, w) outputs computed, padded to 8 x 8
    needs: tuple    # per layer: (h, w) outputs the later layers read
    ints: tuple     # the plan as csrc/conv_chain.cu reads it


def _chain_segment(specs, relus, residuals, final_stride, th, tw
                   ) -> ChainSegment | None:
    """The chain kernel's plan for ``specs`` ((k, Ci, Co) per layer; the
    last at ``final_stride``, the others at 1) over th x tw final tiles, or
    None where the kernel takes no such chain or it does not fit.

    A block computes every layer over the region that the later layers
    read (``needs``: the sum of the later pads, doubled by a stride-2 tail),
    padded to whole M blocks of 8 rows x 8 GEMM rows along w, each of
    chain_outputs(stride, Co) outputs (``regions``), each layer's output
    into a shared-memory buffer (16-byte rows [h][chunk][w parity][w /
    parity], split by parity where its reader has stride 2 or two outputs
    a row) that the next layer's GEMM reads as its A; a buffer lives until
    its last reader (the next layer, or a later layer that adds it as a
    residual) and its bytes are then reused. The input tile is copied
    once: by 8-channel chunks, or for a 3x3 head from 1 or 3 channels to 8
    (two outputs a row) as raw rows from a 16-byte aligned w origin, from
    which each M-block pass gathers the packed head A
    (:func:`pack_head_weight`'s K order)."""
    nl = len(specs)
    ks = [s[0] for s in specs]
    cis = [s[1] for s in specs]
    cos = [s[2] for s in specs]
    strides = [1] * (nl - 1) + [final_stride]
    head = cis[0] in (1, 3)
    outs = [chain_outputs(s, co) for s, co in zip(strides, cos)]
    if (not 0 < nl <= _CHAIN_MAX_LAYERS or th % 8 or tw % (8 * outs[-1])
            or not (head and ks[0] == 3 and cos[0] == 8
                    or cis[0] % 8 == 0)
            or any(k not in (1, 3, 5) for k in ks)
            or any(co % 8 or not 0 < p * co <= _CHAIN_MAX_N
                   for co, p in zip(cos, outs))
            or any(cis[l] != cos[l - 1] for l in range(1, nl))
            or final_stride not in (1, 2)):
        return None
    for m, j in enumerate(residuals):
        if j is not None and not (0 <= j < m and cos[j] == cos[m]
                                  and strides[m] == 1):
            return None
    need = [None] * nl
    off = [0] * nl        # layer l's region starts off[l] before layer
    need[-1] = (th, tw)   # nl-1's (times its stride), in its own grid
    for l in range(nl - 2, -1, -1):
        s, k = strides[l + 1], ks[l + 1]
        need[l] = tuple(s * (e - 1) + k for e in need[l + 1])
        off[l] = s * off[l + 1] + k // 2
    region = [(_ceil8(h), -(-w // (8 * p)) * 8 * p)
              for (h, w), p in zip(need, outs)]

    def reads(l, ext):
        return [strides[l] * (e - 1) + ks[l] for e in ext]
    cx = strides[0] * off[0] + ks[0] // 2
    xh, xw = reads(0, region[0])
    ns = [next(v for v in _TC_MB if v >= p * co) for co, p in zip(cos, outs)]
    qs = []
    for l in range(nl):
        q = (head_chunks(ks[0], cis[0], outs[0]) if l == 0 and head
             else ks[l] * (ks[l] + outs[l] - 1) * cis[l] // 8)
        qs.append((q + q % 2, q))
    # occupants of the shared memory after the table and the weights:
    # (bytes, the layer that writes it (-1: before layer 0), its last reader)
    if head:
        shift = -cx % 8
        x_w = _ceil8(shift + xw)
        x_geo = (0, 1, xh, x_w, shift)      # nch, par, hb, raw pixels a row
        occupants = [(-(-xh * x_w * cis[0] * 2 // 16) * 16, -1, 0),
                     (2 * _CHAIN_MB * qs[0][0] * 64 * 16, -1, 0)]
    else:
        par = strides[0] * outs[0]
        wb = xw + xw % par
        x_geo = (cis[0] // 8, par, xh, wb, 0)
        occupants = [(xh * cis[0] // 8 * wb * 16, -1, 0)]
    bufs = []
    for l in range(nl - 1):
        ext = [max(a, b) for a, b in zip(region[l], reads(l + 1,
                                                          region[l + 1]))]
        readers = [l + 1]
        for m, j in enumerate(residuals):
            if j == l:
                ext = [max(e, r + off[l] - off[m])
                       for e, r in zip(ext, region[m])]
                readers.append(m)
        par = strides[l + 1] * outs[l + 1]
        ext[1] += ext[1] % par
        bufs.append((cos[l] // 8, par, ext[0], ext[1]))
        occupants.append((ext[0] * cos[l] // 8 * ext[1] * 16, l,
                          max(readers)))
    # each occupant takes a free slot (its last reader came before its
    # writer): the smallest that holds it, else the largest, grown
    slots, where = [], []
    for nbytes, t, last in occupants:
        free = [i for i, (_, lu) in enumerate(slots) if lu < t]
        fit = [i for i in free if slots[i][0] >= nbytes]
        if fit:
            i = min(fit, key=lambda i: slots[i][0])
        elif free:
            i = max(free, key=lambda i: slots[i][0])
            slots[i][0] = nbytes
        else:
            slots.append([nbytes, last])
            i = len(slots) - 1
        slots[i][1] = last
        where.append(i)
    weights = [-(-q * n * 16 // 128) * 128 for (q, _), n in zip(qs, ns)]
    tab = [sum(q for q, _ in qs[:l]) // 2 for l in range(nl + 1)]
    plan_bytes = -(-4 * (_CHAIN_HEADER + nl * _CHAIN_LAYER) // 128) * 128
    w_start = plan_bytes + -(-tab[-1] * 8 // 128) * 128
    pos = w_start + sum(weights)
    slot_off = []
    for size, _ in slots:
        slot_off.append(pos)
        pos += -(-size // 128) * 128
    smem = pos
    if smem > _CHAIN_SMEM:
        return None
    x_off = slot_off[where[0]]
    pack_off = slot_off[where[1]] if head else 0
    buf_off = [slot_off[i] for i in where[1 + head:]]

    def geo(l):   # layer l's output buffer: off, nch, wb, par, hb
        nch, par, hb, wb = bufs[l]
        return (buf_off[l], nch, wb, par, hb)
    ints = [nl, th, tw, final_stride, cx, int(head), cis[0], x_off,
            x_geo[0], x_geo[3], x_geo[1], x_geo[2], x_geo[3], x_geo[4],
            pack_off, smem, tab[-1], 0]
    w_glob = so = 0
    w_smem = w_start
    for l in range(nl):
        if l == 0 and head:
            inp = (pack_off, 0, 0, 1, 0)
        elif l == 0:
            inp = (x_off, x_geo[0], x_geo[3], x_geo[1], x_geo[2])
        else:
            inp = geo(l - 1)
        j = residuals[l]
        rb = geo(j) if j is not None else (0,) * 5
        out = geo(l) if l < nl - 1 else (0,) * 5
        # the widest A row offset (stride x h rows) and K-step offset must
        # fit a descriptor's 14 bits of 16-byte units
        if strides[l] * inp[1] * inp[2] > 0x3FFF or \
                ks[l] * inp[1] * inp[2] > 0x3FFF:
            return None
        ints += [ks[l], strides[l], cis[l], cos[l], ns[l], outs[l], *qs[l],
                 int(relus[l]), -1 if j is None else j, *inp, *rb, *out,
                 off[l], *need[l], *region[l],
                 0 if j is None else off[j] - off[l], w_smem, w_glob, so,
                 tab[l]]
        w_smem += weights[l]
        w_glob += qs[l][1] * outs[l] * cos[l] * 8
        so += cos[l]
    return ChainSegment(0, nl - 1, th, tw, smem, tuple(region),
                        tuple(need), tuple(ints))


def _crosses(residuals, cut: int) -> bool:
    """Whether a residual skips over the cut before layer ``cut``."""
    return any(j is not None and j < cut <= m
               for m, j in enumerate(residuals))


@functools.lru_cache(maxsize=None)
def chain_plan(specs: tuple, relus: tuple, residuals: tuple,
               final_stride: int, tile: tuple
               ) -> tuple[ChainSegment, ...] | None:
    """csrc/conv_chain.cu's launches for a chain of 2D convs: ``specs``
    ((k, Ci, Co) per layer), ``relus``, ``residuals`` (None or an earlier
    layer per layer) and the last layer's stride, over final tiles of
    ``tile`` (h, w) outputs. From the first layer on, each launch is the
    longest run of at least two layers that fits, ending before a layer
    over which no residual skips (or at the end); a layer that starts no
    such run is launched alone by :func:`conv_route`, and is in no
    segment. None where no segment fits, or a layer left alone has a
    residual skip over its end."""
    def fits(lo, hi):
        sub = [None if j is None else j - lo for j in residuals[lo:hi]]
        fs = final_stride if hi == len(specs) else 1
        seg = _chain_segment(specs[lo:hi], relus[lo:hi], sub, fs, *tile)
        return seg and seg._replace(first=lo, last=hi - 1)

    out, lo = [], 0
    while lo < len(specs):
        seg = next((g for hi in range(len(specs), lo + 1, -1)
                    if hi == len(specs) or not _crosses(residuals, hi)
                    for g in (fits(lo, hi),) if g), None)
        if seg:
            out.append(seg)
            lo = seg.last + 1
        elif lo + 1 == len(specs) or not _crosses(residuals, lo + 1):
            lo += 1
        else:
            return None
    return tuple(out) or None


# The chains that run on the chain kernel, by (specs, ReLUs, residuals,
# final stride), each with the final tile its plan takes (chain_plan): those
# that it runs faster than the per-layer route on the H100 at DTU eval, at
# the tile that ran them fastest (``python3 chip_smoke.py --chain-tiles``,
# PERF.md section 6): the backbone trunk at 32 x 64, where the whole chain
# does not fit two blocks to an SM, so its 3 -> 8 head and 8 -> 8 conv take
# one launch and its 5x5 stride-2 conv the tc kernel; the 16-channel pair
# at 16 x 32 (three blocks to an SM). Elsewhere the kernel's recomputed
# halos (2.3x the positions through refine's nine layers; 2.25x on the
# first layer of the 32-channel pair, whose blocks fit only two to an SM)
# cost more than the intermediates' round trips through device memory that
# it saves.
CHAIN_FUSED = {
    (((3, 3, 8), (3, 8, 8), (5, 8, 16)), (True,) * 3, (None,) * 3, 2):
        (32, 64),
    (((3, 16, 16),) * 2, (True,) * 2, (None,) * 2, 1): (16, 32),
}


def chain_route(dtype: torch.dtype, specs: tuple, relus: tuple,
                residuals: tuple, final_stride: int = 1) -> str:
    """How a chain of 2D convs runs on the card: "fused" for a bf16 chain
    of CHAIN_FUSED that chain_plan takes at its tile (its segments on
    csrc/conv_chain.cu, the layers' intermediates in shared memory, and
    any layer that no segment takes by conv_route); "layers" (one K4
    launch per layer, each by conv_route) for the rest: f32 chains, the
    chains measured faster per layer, Co > 32 (the backbone's 64-channel
    pair)."""
    key = (specs, relus, residuals, final_stride)
    if (dtype == torch.bfloat16 and key in CHAIN_FUSED
            and chain_plan(*key, CHAIN_FUSED[key])):
        return "fused"
    return "layers"


def conv_route(dtype: torch.dtype, kd: int, k: int, stride: int, ci: int,
               co: int, transposed: bool = False) -> str:
    """Which kernel a conv (``transposed``: the 3x3x3 stride-2 transposed
    conv) launches on the card: "tc" (csrc/conv_tc.cu, wgmma on the tensor
    cores) for a bf16 input with Ci % 8 == 0, Co % 8 == 0, Co <= 64 (32
    transposed) and a tile that fits in shared memory; "co1"
    (csrc/conv_co1.cu) for a 3x3(x3) stride-1 conv to Co = 1 with Ci % 8
    == 0, bf16 or f32 (ProbConv, refine's tail); "direct"
    (csrc/conv_bn_act.cu, f32 FMA) for the rest: f32 with Co > 1, Ci in
    {1, 3} (the trunk's and refine's heads)."""
    if dtype == torch.bfloat16 and tc_plan(kd, k, stride, ci, co,
                                           transposed):
        return "tc"
    if (co == 1 and k == 3 and stride == 1 and not transposed
            and co1_plan(kd, ci, dtype.itemsize)):
        return "co1"
    return "direct"


# ------------------------------------------------------------ kernel launches

@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
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


def _entry(route: str, transposed: bool) -> str:
    """The C entry point (less ``mdf_``) that a launch on ``route`` calls."""
    if route == "tc":
        return "trconv_tc" if transposed else "conv_tc"
    if route in ("co1", "stream"):
        return "conv_" + route
    return "trconv_bn_act" if transposed else "conv_bn_act"


def _launch(counter, x5, w_kio, scale, offset, residual, out_dtype, *, kd, k,
            stride, relu, transposed=False, route=None):
    """Launch the conv (or transposed conv) kernel on (N, D, H, W, Ci) and
    count the launch under ``LAUNCHES[counter]`` (and ``"conv_tc"``,
    ``"conv_co1"`` or ``"conv_stream"`` on those routes), inside the span
    ``kernel/<entry>``.

    ``w_kio``: (*taps, Ci, Co) weights in any float dtype. ``route``: None
    follows :func:`conv_route`; "tc", "co1", "direct" or "stream" (a bf16
    3x3x3 conv on csrc/conv_stream.cu, :func:`stream_route`) forces
    one."""
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
    entry = _entry(route, transposed)
    with tracing.span("kernel/" + entry):
        y = torch.empty((n, do, ho, wo, co), dtype=out_dtype,
                        device=x5.device)
        operands = [(x5, "x"), (y, "out")]
        if residual is not None:
            if residual.shape != y.shape or residual.dtype != out_dtype:
                raise ValueError(
                    f"conv kernel: residual {tuple(residual.shape)} "
                    f"{residual.dtype} does not match the output "
                    f"{tuple(y.shape)} {out_dtype}")
            operands.append((residual, "residual"))
        if route == "tc":
            plan = tc_plan(kd, k, stride, ci, co, transposed,
                           *((di, hi) if transposed else (0, 0)))
            if plan is None or x5.dtype != torch.bfloat16:
                raise ValueError(
                    f"conv tc kernel: no tile for {x5.dtype} kd={kd} k={k} "
                    f"stride={stride} Ci={ci} Co={co}"
                    f"{' (transposed)' if transposed else ''}")
            cop = plan.n
            with tracing.span("prep"):
                w = (pack_trconv_tc_weight(w_kio) if transposed
                     else pack_tc_weight(w_kio, kd=kd, k=k, stride=stride))
                # the kernel reads the first Co entries only
                s, o = scale.float().contiguous(), offset.float().contiguous()
        elif route == "co1":
            plan = co1_plan(kd, ci, x5.element_size())
            if plan is None or co != 1 or k != 3 or stride != 1 \
                    or transposed:
                raise ValueError(
                    f"conv co1 kernel: no tile for {x5.dtype} kd={kd} k={k} "
                    f"stride={stride} Ci={ci} Co={co}"
                    f"{' (transposed)' if transposed else ''}")
            with tracing.span("prep"):
                w = w_kio.float().reshape(-1).contiguous()
                s = scale.float().reshape(1).contiguous()
                o = offset.float().reshape(1).contiguous()
        elif route == "stream":
            plan = stream_plan(ci, co)
            if (plan is None or x5.dtype != torch.bfloat16 or transposed
                    or (kd, k) != (3, 3)):
                raise ValueError(
                    f"conv stream kernel: no tile for {x5.dtype} kd={kd} "
                    f"k={k} stride={stride} Ci={ci} Co={co}"
                    f"{' (transposed)' if transposed else ''}")
            with tracing.span("prep"):
                w = pack_tap_weight(w_kio)
                s, o = scale.float().contiguous(), offset.float().contiguous()
        elif route == "direct":
            if 27 * ci * _COB * 4 > _MAX_SMEM:
                raise ValueError(f"conv kernel: Ci={ci} exceeds the shared "
                                 "memory of the weight stage")
            cop = -(-co // _COB) * _COB
            with tracing.span("prep"):
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
        ptrs = (x5.data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(),
                res_ptr, y.data_ptr())
        if entry == "trconv_tc":
            tiles = (n * -(-di // plan.td) * -(-hi // (8 * plan.bh))
                     * -(-wi // 8))
            err = lib.mdf_trconv_tc(
                *ptrs, n, di, hi, wi, ci, co, cop, int(relu), plan.td,
                plan.bh, trconv_tc_groups(tiles, sm_count(device)),
                int(plan.q_stage == plan.q), dtypes, device, stream)
        elif entry == "conv_tc":
            err = lib.mdf_conv_tc(
                *ptrs, n, di, hi, wi, ci, do, ho, wo, co, cop, kd, k, stride,
                int(relu), plan.td, plan.bh, plan.q, plan.q_stage, dtypes,
                device, stream)
        elif entry == "conv_co1":
            err = lib.mdf_conv_co1(*ptrs, n, di, hi, wi, ci, kd, int(relu),
                                   plan.td, plan.th, plan.tw, plan.channels,
                                   dtypes, device, stream)
        elif entry == "conv_stream":
            err = lib.mdf_conv_stream(*ptrs, n, di, hi, wi, ci, do, ho, wo,
                                      co, plan.n, stride, int(relu),
                                      plan.chunks, plan.smem, dtypes, device,
                                      stream)
        elif entry == "trconv_bn_act":
            err = lib.mdf_trconv_bn_act(*ptrs, n, di, hi, wi, ci, co, cop,
                                        int(relu), dtypes, device, stream)
        else:
            err = lib.mdf_conv_bn_act(*ptrs, n, di, hi, wi, ci, do, ho, wo,
                                      co, cop, kd, k, stride, int(relu),
                                      dtypes, device, stream)
        build.check(err, entry)
        if route == "tc":
            LAUNCHES["conv_tc"] += 1
            TC_LAUNCHES[counter] += 1
        elif route in ("co1", "stream"):
            LAUNCHES[entry] += 1
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
    ``LAUNCHES[counter]``. ``route`` ("tc", "co1" or "direct") overrides
    :func:`conv_route`, to compare the kernels."""
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
    plan = pair_plan(x.dtype, n, d, h, w, ci, cm, co,
                     sm_count(x.device.index))
    if plan is None:
        raise ValueError(f"conv3d pair kernel: no plan for Cm={cm} (a "
                         f"multiple of {_COB} whose intermediate tile fits)")
    entry = "conv3d_pair_tc" if plan.route == "tc" else "conv3d_pair"
    with tracing.span("kernel/" + entry):
        y = torch.empty((n, d, h, w, co), dtype=x.dtype, device=x.device)
        with tracing.span("prep"):
            if plan.route == "tc":
                w1k = pack_tap_weight(w1.permute(2, 3, 4, 1, 0))
                w2k = pack_tap_weight(w2.permute(2, 3, 4, 1, 0))
                s1p, o1p, s2p, o2p = (v.float().contiguous()
                                      for v in (s1, o1, s2, o2))
            else:
                cop = -(-co // _COB) * _COB
                w1k = w1.float().permute(2, 3, 4, 1, 0) \
                    .reshape(27 * ci, cm).contiguous()
                w2k = _padded(w2.float().permute(2, 3, 4, 1, 0)
                              .reshape(27 * cm, co), cop)
                s1p, o1p = s1.float().contiguous(), o1.float().contiguous()
                s2p, o2p = _padded(s2, cop), _padded(o2, cop)
        for t, name in ((x, "x"), (w1k, "w1"), (s1p, "s1"), (o1p, "o1"),
                        (w2k, "w2"), (s2p, "s2"), (o2p, "o2"), (y, "out")):
            build.check_operand(t, name)
        device, stream = build.launch_context(x)
        lib = build.load_library()
        ptrs = (x.data_ptr(), w1k.data_ptr(), s1p.data_ptr(), o1p.data_ptr(),
                w2k.data_ptr(), s2p.data_ptr(), o2p.data_ptr(), y.data_ptr())
        if plan.route == "tc":
            err = lib.mdf_conv3d_pair_tc(
                *ptrs, n, d, h, w, ci, cm, co, int(relu), plan.th, plan.tw,
                plan.planes, plan.ring, plan.taps, plan.smem, device, stream)
        else:
            err = lib.mdf_conv3d_pair(
                *ptrs, n, d, h, w, ci, cm, co, cop, int(relu),
                _DTYPES[(x.dtype, x.dtype)], device, stream)
        build.check(err, "conv3d_pair")
        LAUNCHES["conv3d_pair_bn_act"] += 1
    return y


def chain_weights(weights, seg: ChainSegment, final_stride: int,
                  ci: int) -> list:
    """Layers seg.first .. seg.last's weights (the chain's list) packed as
    the chain kernel takes them, flat, one after another: a Ci = 1 or 3
    head by :func:`pack_head_weight`, the rest by
    :func:`pack_chain_weight`."""
    out = []
    for l in range(seg.first, seg.last + 1):
        wt = weights[l]
        stride = final_stride if l == len(weights) - 1 else 1
        p = chain_outputs(stride, wt.shape[0])
        out.append((pack_head_weight(wt, p) if l == seg.first
                    and ci in (1, 3) else pack_chain_weight(
                        wt, stride=stride, p=p)).reshape(-1))
    return out


@functools.lru_cache(maxsize=None)
def _plan_array(ints: tuple):
    """A segment's plan as the C array the chain kernel's entry point
    copies (kept alive with the plan)."""
    return (ctypes.c_int * len(ints))(*ints)


def _chain_launch(x, weights, scales, offsets, seg: ChainSegment, *,
                  final_stride, out_dtype):
    """Launch the chain kernel for layers seg.first .. seg.last (their
    weights, scales and offsets: the chain's lists) on x (N, H, W, Ci) bf16
    and count the launch under ``LAUNCHES["conv2d_chain"]``."""
    nb, h, w, ci = x.shape
    layers = range(seg.first, seg.last + 1)
    with tracing.span("kernel/conv_chain"):
        with tracing.span("prep"):
            wcat = torch.cat(chain_weights(weights, seg, final_stride, ci))
            s = torch.cat([scales[l].float() for l in layers])
            o = torch.cat([offsets[l].float() for l in layers])
        stride = final_stride if seg.last == len(weights) - 1 else 1
        ho, wo = -(-h // stride), -(-w // stride)
        y = torch.empty((nb, ho, wo, weights[seg.last].shape[0]),
                        dtype=out_dtype, device=x.device)
        for t, name in ((x, "x"), (wcat, "weight"), (s, "scale"),
                        (o, "offset"), (y, "out")):
            build.check_operand(t, name)
        device, stream = build.launch_context(x)
        lib = build.load_library()
        plan = _plan_array(seg.ints)
        err = lib.mdf_conv_chain(
            x.data_ptr(), wcat.data_ptr(), s.data_ptr(), o.data_ptr(),
            y.data_ptr(), ctypes.addressof(plan), len(seg.ints), nb, h, w,
            ho, wo, _DTYPES[(x.dtype, out_dtype)], device, stream)
        build.check(err, "conv_chain")
        LAUNCHES["conv2d_chain"] += 1
    return y


def conv2d_chain(x: torch.Tensor, weights, scales, offsets, *,
                 relu_flags: tuple = (), residuals: tuple | None = None,
                 final_stride: int = 1, plain: bool = False,
                 route: str | None = None, out_dtype=None) -> torch.Tensor:
    """A chain of 2D convs (K5), computing what ``conv2d_chain_fused`` does.

    Args:
        x: (N, H, W, Ci).
        weights: per-layer (Co, Ci, k, k) torch-layout weights.
        scales, offsets: per-layer (Co,) epilogues.
        relu_flags: per-layer ReLU (default: all True).
        residuals: per-layer ``None`` or an earlier layer index j: add layer
            j's output after this layer's ReLU (Res-block skips).
        final_stride: stride of the LAST layer (1 or 2); the others are 1.
        route: None follows :func:`chain_route`; "fused" forces the chain
            kernel at the chain's tile in CHAIN_FUSED (its plan's segments,
            any other layer by conv_route), "layers" one launch per layer
            by :func:`conv_route`, "direct" one per layer on the direct
            kernel (to compare them).
        out_dtype: the last layer's dtype (default x's; the chain kernel
            also writes f32 from bf16).
    Returns:
        The last layer's output; every intermediate is rounded to x's dtype.
    """
    nlayers = len(weights)
    relu_flags = tuple(relu_flags) or (True,) * nlayers
    residuals = tuple(residuals or (None,) * nlayers)
    out_dtype = out_dtype or x.dtype
    if not (len(relu_flags) == len(residuals) == nlayers):
        raise ValueError("conv2d_chain: per-layer lists differ in length")
    segments = {}
    if not (plain or not x.is_cuda):
        key = (tuple((int(w.shape[-1]), int(w.shape[1]), int(w.shape[0]))
                     for w in weights), relu_flags, residuals, final_stride)
        route = route or chain_route(x.dtype, *key)
        if route == "fused":
            plan = key in CHAIN_FUSED and chain_plan(*key, CHAIN_FUSED[key])
            if not plan or x.dtype != torch.bfloat16:
                raise ValueError(f"conv chain kernel: no plan for {x.dtype} "
                                 f"{key[0]} residuals {residuals} "
                                 f"final_stride {final_stride}")
            segments = {seg.first: seg for seg in plan}
        elif route not in ("layers", "direct"):
            raise ValueError(f"conv2d_chain: unknown route {route!r}")
    keep = {j for j in residuals if j is not None}
    kept, v, layer = {}, x, 0
    while layer < nlayers:
        last = layer == nlayers - 1
        if layer in segments:
            seg = segments[layer]
            v = _chain_launch(
                v.contiguous(), weights, scales, offsets, seg,
                final_stride=final_stride,
                out_dtype=out_dtype if seg.last == nlayers - 1 else x.dtype)
            layer = seg.last + 1
            continue
        res = kept[residuals[layer]] if residuals[layer] is not None else None
        kw = dict(stride=final_stride if last else 1, relu=relu_flags[layer],
                  residual=res, out_dtype=out_dtype if last else x.dtype)
        if plain or not x.is_cuda:
            v = _conv_plain(v, weights[layer], scales[layer], offsets[layer],
                            **kw)
        else:
            v = _conv2d_launch(
                "conv2d_bn_act", v, weights[layer], scales[layer],
                offsets[layer], route="direct" if route == "direct" else None,
                **kw)
        if layer in keep:
            kept[layer] = v
        layer += 1
    return v
