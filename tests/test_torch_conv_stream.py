"""The depth-streamed tensor-core pair (K10, csrc/conv3d_pair.cu's
tensor-core body) and the K-streamed conv (csrc/conv_stream.cu, the
transposed conv's input gradient where ``stream_route`` sends it), on the
CPU: their plans, an emulation of each kernel's addressing on its plan (the
same buffers, ring slots, shifted starts and zero fills, f32 sums of bf16
values) against the plain version at odd extents, the route rule at the DTU
train shapes, and the plain versions against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import to_torch
from mdfnet_tpu.ops.pallas.conv3d_kernel import conv3d_pair_bn_relu
from mdfnet_tpu.ops.pallas.conv3d_vjp import trconv3d_train as jax_trconv3d
from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.models.conv_routes import (eval_conv_routes,
                                                 train_unet_routes)
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.ops.cuda import conv_kernel
from mdfnet_tpu_torch.ops.cuda.conv_kernel import (
    _MAX_SMEM, _PAIR_BLOCKS, _conv_plain, conv3d_pair_bn_act,
    conv3d_pair_bn_act_plain, conv_route, pack_tap_weight, pair_geometry,
    pair_plan, stream_plan, stream_route, tc_plan, two_per_sm)
from mdfnet_tpu_torch.ops.cuda.conv_vjp import trconv3d_train

BF16 = torch.bfloat16
# the stage-0 U-Net's stride-1 pairs at DTU eval (1600 x 1184, 48 planes)
PAIRS = [((1, 48, 148, 200), 32, 16, 16), ((1, 24, 74, 100), 32, 32, 32),
         ((1, 12, 37, 50), 64, 64, 64)]
# the emulation's f32 sums of bf16 products against the plain pair's f32
# convolutions: the same terms in another order, and the intermediate
# rounded to bf16 by both (a value next to a rounding boundary may round
# the other way: one bf16 step, 2^-8 of it, through the second conv)
EMU_TOL = 2e-3


def _rand_pair(rng, shape, ci, cm, co):
    """bf16 x, weights and epilogues; offsets o1 >= 0.5 so that an
    intermediate voxel outside the volume that took relu(o1) instead of
    zero shows at every border."""
    x = torch.from_numpy(rng.randn(*shape, ci).astype(np.float32)).to(BF16)
    w1 = torch.from_numpy((rng.randn(cm, ci, 3, 3, 3) * 0.1)
                          .astype(np.float32)).to(BF16)
    w2 = torch.from_numpy((rng.randn(co, cm, 3, 3, 3) * 0.1)
                          .astype(np.float32)).to(BF16)
    s1 = torch.from_numpy((0.5 + rng.rand(cm)).astype(np.float32))
    o1 = torch.from_numpy((0.5 + rng.rand(cm)).astype(np.float32))
    s2 = torch.from_numpy((0.5 + rng.rand(co)).astype(np.float32))
    o2 = torch.from_numpy(rng.randn(co).astype(np.float32) * 0.3)
    return x, w1, s1, o1, w2, s2, o2


def emulate_pair_tc(x, w1, s1, o1, w2, s2, o2, plan, relu=True,
                    halo_fault=False):
    """csrc/conv3d_pair.cu's tensor-core body on ``plan``, block by block:
    the input and intermediate rings as [slot][chunk][row][8] (rows never
    written hold NaN, so a useful row that reads one shows), the first
    conv's GEMM rows at the pitch, each tap a shifted slice of its ring
    slot, the epilogue's zero outside the volume and the bf16 rounding,
    the second conv from the intermediate slots. ``halo_fault``: the
    intermediate's halo rows zeroed (the fault chip_smoke.py injects)."""
    n, dd, hh, ww, ci = x.shape
    cm, co = w1.shape[0], w2.shape[0]
    assert plan.route == "tc"
    w1k = pack_tap_weight(w1.permute(2, 3, 4, 1, 0)).float()
    w2k = pack_tap_weight(w2.permute(2, 3, 4, 1, 0)).float()
    p = plan.pitch
    nb1, nb2 = plan.mblocks
    npx, npm = plan.rows
    th, tw, ring = plan.th, plan.tw, plan.ring
    nchx, nchm = ci // 8, cm // 8
    xf = x.float()
    y = torch.full((n, dd, hh, ww, co), float("nan"))
    nan = float("nan")

    def products(buf, slots, nch, nb, wk):
        rows = 64 * nb
        acc = torch.zeros(rows, wk.shape[1])
        for tap in range(27):
            kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
            off = kh * p + kw
            for c in range(nch):
                a = buf[slots[kd], c, off:off + rows]
                assert a.shape[0] == rows, "a tap reads past its chunk"
                acc += a @ wk[tap * nch + c].T
        return acc

    gw, gh, gz = plan.grid
    segs = gz // n
    for z in range(gz):
        seg, item = z % segs, z // segs
        d0 = seg * plan.planes
        planes = min(plan.planes, dd - d0)
        for by in range(gh):
            for bx in range(gw):
                h0, w0 = by * th, bx * tw
                xr = torch.full((ring, nchx, npx, 8), nan)
                mr = torch.full((3, nchm, npm, 8), nan)

                def load(r):
                    pl = d0 - 2 + r
                    reg = torch.zeros(th + 4, tw + 4, ci)
                    if 0 <= pl < dd:
                        hl, hu = max(0, h0 - 2), min(hh, h0 + th + 2)
                        wl, wu = max(0, w0 - 2), min(ww, w0 + tw + 2)
                        if hl < hu and wl < wu:
                            reg[hl - h0 + 2:hu - h0 + 2,
                                wl - w0 + 2:wu - w0 + 2] = \
                                xf[item, pl, hl:hu, wl:wu]
                    xr[r % ring, :, :(th + 4) * p] = reg.reshape(
                        (th + 4) * p, nchx, 8).permute(1, 0, 2)

                for r in range(3):
                    load(r)
                for j in range(planes + 2):
                    m = d0 - 1 + j
                    if ring == 4 and j <= planes:
                        load(j + 3)
                    if 0 <= m < dd:
                        acc = products(xr, [j % ring, (j + 1) % ring,
                                            (j + 2) % ring], nchx, nb1, w1k)
                        pos = torch.arange(64 * nb1)
                        lh, lw = pos // p, pos % p
                        gh_, gw_ = h0 - 1 + lh, w0 - 1 + lw
                        inside = ((lh < th + 2) & (lw < tw + 2) & (gh_ >= 0)
                                  & (gh_ < hh) & (gw_ >= 0) & (gw_ < ww))
                        if halo_fault:
                            inside &= ((lh > 0) & (lh < th + 1) & (lw > 0)
                                       & (lw < tw + 1))
                        v = acc * s1 + o1
                        if relu:
                            v = torch.relu(v)
                        v = torch.where(inside[:, None], v, 0.0)
                        mr[j % 3, :, :64 * nb1] = v.to(BF16).float() \
                            .reshape(-1, nchm, 8).permute(1, 0, 2)
                    else:
                        mr[j % 3] = 0.0
                    if ring == 3 and j <= planes:
                        load(j + 3)
                    if j >= 2:
                        acc = products(mr, [(j - 2) % 3, (j - 1) % 3, j % 3],
                                       nchm, nb2, w2k)
                        v = acc * s2 + o2
                        if relu:
                            v = torch.relu(v)
                        pos = torch.arange(64 * nb2)
                        lh, lw = pos // p, pos % p
                        keep = ((lh < th) & (lw < tw) & (h0 + lh < hh)
                                & (w0 + lw < ww))
                        y[item, m - 1, h0 + lh[keep], w0 + lw[keep]] = \
                            v[keep]
    return y


def _reference_pair(x, w1, s1, o1, w2, s2, o2, relu):
    """The plain pair with the output in f32: the intermediate rounded to
    bf16 as the kernel rounds it."""
    mid = _conv_plain(x, w1, s1, o1, stride=1, relu=relu, residual=None,
                      out_dtype=BF16)
    return _conv_plain(mid, w2, s2, o2, stride=1, relu=relu, residual=None,
                       out_dtype=torch.float32)


# ------------------------------------------------------------ pair_plan

@pytest.mark.parametrize("shape,ci,cm,co", PAIRS + [
    ((1, 5, 11, 19), 32, 16, 16), ((2, 3, 9, 17), 16, 32, 64),
    ((1, 7, 13, 23), 64, 64, 64), ((1, 1, 1, 1), 16, 16, 16),
    ((3, 9, 37, 50), 16, 64, 32)])
def test_pair_plan_fits(shape, ci, cm, co):
    """The tensor-core plan: its shared memory (the geometry's) fits a
    block; each conv's M blocks fit four warpgroups' registers; the chunk
    rows hold the plane and what the last M block's taps read past it;
    the D segments cover D once; the grid covers H and W."""
    n, d, h, w = shape
    plan = pair_plan(BF16, n, d, h, w, ci, cm, co, 132)
    assert plan.route == "tc"
    p, nb1, nb2, npx, npm, smem = pair_geometry(
        plan.th, plan.tw, ci, cm, co, plan.ring, plan.taps)
    assert (p, (nb1, nb2), (npx, npm), smem) == (
        plan.pitch, plan.mblocks, plan.rows, plan.smem)
    assert p == plan.tw + 4 and smem <= _MAX_SMEM
    assert 64 * nb1 >= (plan.th + 2) * p > 64 * (nb1 - 1)
    assert 64 * nb2 >= plan.th * p > 64 * (nb2 - 1)
    assert nb1 <= _PAIR_BLOCKS[cm] and nb2 <= _PAIR_BLOCKS[co]
    assert npx >= max((plan.th + 4) * p, 64 * nb1 + 2 * p + 2)
    assert npm >= max(64 * nb1, 64 * nb2 + 2 * p + 2)
    assert plan.ring in (3, 4) and plan.taps in (27, 9, 3)
    gw, gh, gz = plan.grid
    segs = gz // n
    assert gz == n * segs and (segs - 1) * plan.planes < d <= \
        segs * plan.planes
    assert (gh - 1) * plan.th < h <= gh * plan.th
    assert (gw - 1) * plan.tw < w <= gw * plan.tw


def test_pair_plan_at_the_dtu_pairs():
    """The first pair holds both convs' weights and walks all 48 planes
    with 130 blocks for 132 SMs; the others split D to fill the card and
    the 64-channel pair streams its weights (442 KB whole)."""
    plans = [pair_plan(BF16, *s, ci, cm, co, 132)
             for s, ci, cm, co in PAIRS]
    first = plans[0]
    assert (first.th, first.tw, first.planes, first.taps) == (16, 16, 48, 27)
    assert first.grid[0] * first.grid[1] * first.grid[2] == 130
    assert plans[2].taps < 27
    for plan in plans:
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] <= 2 * 132


@pytest.mark.parametrize("dtype,ci,cm,co", [
    (torch.float32, 32, 16, 16), (BF16, 8, 8, 3), (BF16, 3, 8, 1),
    (BF16, 16, 8, 16), (BF16, 16, 16, 24)])
def test_pair_plan_sends_the_rest_to_the_cuda_cores(dtype, ci, cm, co):
    plan = pair_plan(dtype, 1, 5, 11, 19, ci, cm, co, 132)
    assert plan.route == "direct" and plan.smem == 720 * cm * \
        dtype.itemsize


# ------------------------------------------- the pair kernel's addressing

@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,ci,cm,co,sms", [
    ((1, 5, 11, 19), 32, 16, 16, 132),     # one column, odd extents
    ((2, 4, 9, 21), 16, 32, 64, 132),
    ((1, 6, 7, 10), 64, 64, 64, 132),      # weights streamed
    ((1, 9, 20, 22), 16, 16, 32, 4),       # few SMs: long walks
    ((1, 7, 18, 37), 32, 16, 16, 1000)])   # many SMs: short segments
def test_pair_tc_addressing_matches_the_plain_pair(shape, ci, cm, co, sms,
                                                   relu):
    """The emulation of the tensor-core body's buffers and addressing on
    its plan vs the plain pair, bf16 inputs (tolerance EMU_TOL of the
    largest output: sum order and the intermediate's rounding only)."""
    rng = np.random.RandomState(sum(shape) + ci + cm + co)
    args = _rand_pair(rng, shape, ci, cm, co)
    plan = pair_plan(BF16, *shape, ci, cm, co, sms)
    got = emulate_pair_tc(*args, plan, relu=relu)
    want = _reference_pair(*args, relu)
    assert not torch.isnan(got).any()
    err = (got - want).abs().max().item()
    assert err <= EMU_TOL * want.abs().max().item(), (plan, err)


def test_pair_tc_halo_fault_reads_far_over_the_tolerance():
    """The fault chip_smoke.py injects into the kernel (the intermediate's
    halo rows zeroed) reads more than 2x the kernel's bf16 tolerance
    (1e-2) against the plain pair, so the card's check can see it."""
    rng = np.random.RandomState(3)
    args = _rand_pair(rng, (1, 4, 20, 24), 32, 16, 16)
    plan = pair_plan(BF16, 1, 4, 20, 24, 32, 16, 16, 132)
    got = emulate_pair_tc(*args, plan, halo_fault=True)
    want = _reference_pair(*args, True)
    assert (got - want).abs().max().item() >= 2e-2 * want.abs().max().item()


def test_pair_cpu_wrapper_takes_the_plain_pair():
    rng = np.random.RandomState(5)
    args = _rand_pair(rng, (1, 3, 5, 7), 16, 16, 16)
    before = dict(conv_kernel.LAUNCHES)
    got = conv3d_pair_bn_act(*args)
    assert torch.equal(got, conv3d_pair_bn_act_plain(*args))
    assert conv_kernel.LAUNCHES == before


# ------------------------------------------------- the pair against JAX

def _torch_weight(k):
    return np.ascontiguousarray(np.moveaxis(k, (-1, -2), (0, 1)))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,ci,cm,co,th,td", [
    ((3, 5, 7), 8, 8, 8, 4, 2),      # odd D, H, W
    ((5, 6, 9), 16, 16, 8, 3, 2)])   # a tile that does not divide H, D
def test_pair_plain_matches_pallas_pair(shape, ci, cm, co, th, td, relu):
    """The plain pair (what the kernel is held to) vs the TPU pair kernel
    in interpret mode at odd extents, with and without the ReLU; f32, the
    Pallas tests' bound for f32 sums of <= 1728 terms (3e-4)."""
    rng = np.random.RandomState(80 + ci + int(relu))
    x = rng.randn(1, *shape, ci).astype(np.float32)
    k1 = (rng.randn(3, 3, 3, ci, cm) * 0.2).astype(np.float32)
    k2 = (rng.randn(3, 3, 3, cm, co) * 0.2).astype(np.float32)
    s1, o1 = (0.5 + rng.rand(cm)).astype(np.float32), \
        (0.5 + rng.rand(cm)).astype(np.float32)
    s2, o2 = (0.5 + rng.rand(co)).astype(np.float32), \
        rng.randn(co).astype(np.float32)
    got = conv3d_pair_bn_act(*to_torch(x, _torch_weight(k1), s1, o1,
                                       _torch_weight(k2), s2, o2),
                             relu=relu).numpy()
    pallas = conv3d_pair_bn_relu(
        jnp.asarray(x[0].transpose(0, 1, 3, 2)), jnp.asarray(k1),
        jnp.asarray(s1), jnp.asarray(o1), jnp.asarray(k2), jnp.asarray(s2),
        jnp.asarray(o2), th=th, td=td, relu=relu, interpret=True)
    np.testing.assert_allclose(got[0],
                               np.asarray(pallas).transpose(0, 1, 3, 2),
                               atol=3e-4)


# ------------------------------------------------ the K-streamed conv

def emulate_conv_stream(x, weight, scale, offset, stride, plan, relu=True):
    """csrc/conv_stream.cu on ``plan``: blocks of 64 consecutive output
    voxels; per stage, A gathered per row from each chunk's tap (zero
    outside the volume, past the last chunk, past the last voxel) as
    [chunk][row], B the chunks' packed weights; f32 sums; the epilogue."""
    nb, di, hi, wi, ci = x.shape
    co = weight.shape[0]
    do, ho, wo = (-(-e // stride) for e in (di, hi, wi))
    m = nb * do * ho * wo
    nch, q_end = ci // 8, 27 * (ci // 8)
    wk = pack_tap_weight(weight.permute(2, 3, 4, 1, 0)).float()
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 2, 1, 2, 1, 2))
    tm = 64
    nstages = -(-q_end // plan.chunks)
    y = torch.empty(m, co)
    for m0 in range(0, m, tm):
        p = torch.arange(m0, m0 + tm)
        valid = p < m
        pc = p.clamp(max=m - 1)
        ow, oh = pc % wo, pc // wo % ho
        od, n = pc // (wo * ho) % do, pc // (wo * ho * do)
        acc = torch.zeros(tm, co)
        for st in range(nstages):
            for jq in range(plan.chunks):
                q = st * plan.chunks + jq
                if q >= q_end:
                    continue       # zero-filled A and B
                tap, c = divmod(q, nch)
                kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
                # padded coordinates: input s o - 1 + k sits at s o + k
                a = xp[n, stride * od + kd, stride * oh + kh,
                       stride * ow + kw, 8 * c:8 * c + 8]
                a = torch.where(valid[:, None], a, 0.0)
                acc += a @ wk[q].T
        v = acc * scale + offset
        if relu:
            v = torch.relu(v)
        y[p[valid]] = v[valid]
    return y.reshape(nb, do, ho, wo, co)


@pytest.mark.parametrize("shape,ci,co,stride", [
    ((2, 7, 9, 11), 32, 64, 2),    # the trconv dgrad's class, odd extents
    ((1, 5, 6, 13), 16, 32, 2),
    ((2, 4, 7, 9), 8, 16, 2),      # Ci = 8: a stage spans 4 taps
    ((1, 3, 5, 6), 64, 24, 2),     # Co padded to 32
    ((1, 4, 6, 7), 16, 16, 1)])
def test_stream_addressing_matches_the_plain_conv(shape, ci, co, stride):
    """The emulation of the stream kernel's gather and stages on its plan
    vs the plain conv (f32 sums of bf16 values, the same terms in another
    order: 1e-4 of the largest output)."""
    rng = np.random.RandomState(ci + co + stride)
    x = torch.from_numpy(rng.randn(*shape, ci).astype(np.float32)).to(BF16)
    w = torch.from_numpy((rng.randn(co, ci, 3, 3, 3) * 0.1)
                         .astype(np.float32)).to(BF16)
    sc = torch.from_numpy((0.5 + rng.rand(co)).astype(np.float32))
    of = torch.from_numpy(rng.randn(co).astype(np.float32) * 0.3)
    want = _conv_plain(x, w, sc, of, stride=stride, relu=True, residual=None,
                       out_dtype=torch.float32)
    got = emulate_conv_stream(x, w, sc, of, stride, stream_plan(ci, co))
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("ci,co", [(8, 16), (16, 32), (32, 64), (64, 64),
                                   (64, 8)])
def test_stream_plan(ci, co):
    """N is Co padded to 16, 32 or 64; a stage holds four taps' chunks, at
    most 32 (a divisor of the block's 128 threads); the shared memory the
    kernel's (64 rows' origins, three stages of A and B), which also holds
    the epilogue's f32 stage."""
    plan = stream_plan(ci, co)
    assert plan.n == max(16, 1 << (co - 1).bit_length())
    assert plan.chunks == min(4 * ci // 8, 32) and 128 % plan.chunks == 0
    assert plan.smem == 16 * (64 + 3 * plan.chunks * (65 + plan.n))
    assert plan.smem <= _MAX_SMEM and 64 * 16 + 64 * (plan.n + 8) * 4 <= \
        plan.smem
    assert stream_plan(12, 16) is None and stream_plan(16, 72) is None


# --------------------------------------------------------- the route rule

def test_stream_route_selects_the_starved_trconv_input_gradients():
    """At DTU train (B = 4, 640 x 512) on 132 SMs the rule sends the
    transposed convs' input gradients from 32 to 64 channels (one a stage:
    the tc plan's 214 KB tile lets one block on an SM and its grid has 72,
    24 and 80 blocks) to the stream kernel, and every other conv launch of
    the U-Nets, forward and input gradient, to conv_route's kernel; the
    eval forward takes no stream launch."""
    model = build_model(ModelConfig(compute_dtype="bfloat16"), device="cpu")
    routes = train_unet_routes(model, 4, 512, 640, 132)
    streamed = [r for r in routes if r[-1] == "stream"]
    assert [(r[4], r[5]) for r in streamed] == [
        ((4, 24, 32, 40, 32), 64), ((4, 6, 32, 40, 32), 64),
        ((4, 2, 64, 80, 32), 64)]
    trconv_dgrads = [r for r in routes if r[0] == "dgrad" and r[3] == 2
                     and not r[6]]
    assert len(trconv_dgrads) == 8
    for what, kd, k, s, xs, co, tr, route in routes:
        if route == "stream":
            assert what == "dgrad" and (kd, k, s, tr) == (3, 3, 2, False)
            plan = tc_plan(3, 3, 2, xs[-1], co)
            assert not two_per_sm(plan.smem)
        else:
            assert route == conv_route(BF16, kd, k, s, xs[-1], co, tr)
    assert "stream" not in eval_conv_routes(model)


@pytest.mark.parametrize("dtype,shape,ci,co,sms,want", [
    (BF16, (4, 24, 32, 40), 32, 64, 132, "stream"),
    (BF16, (4, 24, 32, 40), 32, 64, 64, "tc"),          # grid fills the card
    (torch.float32, (4, 24, 32, 40), 32, 64, 132, "direct"),
    (BF16, (4, 48, 64, 80), 16, 32, 132, "tc"),         # 480 blocks
    (BF16, (4, 2, 64, 80), 16, 32, 1000, "stream"),     # 320 blocks
    (BF16, (4, 4, 64, 80), 8, 16, 1000, "tc"),          # two blocks an SM
    (BF16, (4, 24, 128, 160), 8, 16, 132, "tc")])
def test_stream_route_cases(dtype, shape, ci, co, sms, want):
    assert stream_route(dtype, 3, 3, 2, ci, co, shape, sms) == want
    assert stream_route(dtype, 3, 3, 1, ci, co, shape, sms) == conv_route(
        dtype, 3, 3, 1, ci, co)


# ------------------------------------ the trconv input gradient vs JAX

def _dhcw(a):   # (B, D, H, W, C) <-> (B, D, H, C, W)
    return np.ascontiguousarray(np.swapaxes(a, -1, -2))


@pytest.mark.parametrize("shape,ci,co", [((2, 3, 4, 5), 64, 32),
                                         ((1, 3, 5, 7), 32, 16)])
def test_trconv_input_gradient_matches_jax(shape, ci, co):
    """trconv3d_train's input gradient (the stride-2 conv of the cotangent,
    the class stream_route sends to the stream kernel) vs the VJP of JAX's
    trconv3d_train and vs the XLA transposed conv's autodiff, at odd
    extents; f32 (1e-4: sum order only)."""
    rng = np.random.RandomState(ci + co)
    x = rng.randn(*shape, ci).astype(np.float32)
    k = (rng.randn(3, 3, 3, co, ci) * 0.1).astype(np.float32)   # (*k, O, I)
    b, d, h, w = shape
    ct = rng.randn(b, 2 * d, 2 * h, 2 * w, co).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = trconv3d_train(xt, torch.from_numpy(
        np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2))))
    (y * torch.from_numpy(ct)).sum().backward()
    _, vjp = jax.vjp(lambda a: jax_trconv3d(a, jnp.asarray(k), True),
                     jnp.asarray(_dhcw(x)))
    dx_j, = vjp(jnp.asarray(_dhcw(ct)))
    np.testing.assert_allclose(xt.grad.numpy(), _dhcw(np.asarray(dx_j)),
                               atol=1e-4)
    kf = jnp.swapaxes(jnp.flip(jnp.asarray(k), (0, 1, 2)), -1, -2)

    def xla(a):
        return jax.lax.conv_general_dilated(
            a, kf, (1, 1, 1), [(1, 2)] * 3, lhs_dilation=(2, 2, 2),
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    _, vjp = jax.vjp(xla, jnp.asarray(x))
    dx_x, = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_x), atol=1e-4)
