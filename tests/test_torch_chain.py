"""The conv chain (K5) on its fused route (csrc/conv_chain.cu): its plan
(``conv_kernel.chain_plan``), the packed head's plain mirror, and the plain
chain against the TPU chain kernel in Pallas interpret mode.

The chain kernel has no CPU mode, so ``_emulate`` executes a plan the way
the kernel does, on a shared memory of bf16 slots filled with NaN: the
input tile's copy, each layer's K-step descriptors (start row, LBO, SBO)
over its input buffer or the packed head, the B core matrices, the
epilogue's writes into the next buffer (zero outside the image) and the
masked final store. Any read of a slot the plan never wrote turns an
output NaN. Its sums are exact (f64) and its intermediates bf16, so it
agrees with the plain chain (f32 sums, bf16 intermediates) within the
bf16 tolerance of the card's tests, 1e-2 of max |plain|."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdfnet_tpu.ops.pallas.conv2d_kernel import conv2d_chain_fused
from mdfnet_tpu_torch.ops.cuda import conv_kernel
from mdfnet_tpu_torch.ops.cuda.conv_kernel import (
    _conv_plain, chain_head_plain, chain_outputs, chain_plan, chain_route,
    chain_weights, conv2d_chain, head_chunks, pack_chain_weight, pack_head_weight,
    pack_tc_weight)

BF16_TOL = 1e-2    # of max |plain|: the card tests' bf16 tolerance
ATOL = 3e-4        # f32 sums of <= 1728 terms (the Pallas tests' bound)

# the DTU eval forward's chains at 1600x1184 x 5 views, B = 1:
# (specs, relus, residuals, final_stride, input (N, H, W, Ci))
TRUNK = (((3, 3, 8), (3, 8, 8), (5, 8, 16)), (True,) * 3, (None,) * 3, 2,
         (5, 1184, 1600, 3))
REFINE = (((3, 1, 8),) + ((3, 8, 8),) * 7 + ((3, 8, 32),),
          (False,) + (True, False) * 3 + (False, False),
          (None, None, 0, None, 2, None, 4, 0, None), 1, (1, 592, 800, 1))


def _pair(c, h, w):
    return (((3, c, c),) * 2, (True, True), (None, None), 1, (5, h, w, c))


DTU_CHAINS = {"trunk": TRUNK, "x2": _pair(16, 592, 800),
              "x3": _pair(32, 296, 400), "x4": _pair(64, 148, 200),
              "refine": REFINE}
# a final tile at which each chain is one launch (the trunk's tile in
# CHAIN_FUSED, 32 x 64, leaves its stride-2 tail to the tc kernel)
TILES = {"trunk": (16, 16), "x2": (16, 32), "x3": (8, 16), "x4": (16, 32),
         "refine": (16, 16)}


def _chain_args(rng, specs, shape, dtype=torch.bfloat16):
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    ws = [torch.from_numpy((rng.randn(co, ci, k, k) * (1.0 / (k * (ci ** 0.5))))
                           .astype(np.float32)).to(dtype)
          for k, ci, co in specs]
    scales = [torch.from_numpy((0.5 + rng.rand(co)).astype(np.float32))
              for _, _, co in specs]
    # offsets away from 0: a padding position that took relu(offset)
    # instead of zero would show at every border
    offsets = [torch.from_numpy((0.3 + 0.2 * rng.rand(co)).astype(np.float32))
               for _, _, co in specs]
    return x, ws, scales, offsets


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _fields(ints):
    """The plan's header and layer records as dicts (conv_chain.cu)."""
    head, rec = conv_kernel._CHAIN_HEADER, conv_kernel._CHAIN_LAYER
    hdr = dict(zip(("nl th tw mx cx head ci0 x_off x_nch x_wb x_par x_hb x_w "
                    "shift pack_off smem tab_entries reserved").split(),
                   ints[:head]))
    names = ("k s ci co n p q q_real relu res".split()
             + [f"{b}_{f}" for b in ("in", "rb", "out")
                for f in ("off", "nch", "wb", "par", "hb")]
             + "c eh ew ph pw res_dc w_smem w_glob so tab".split())
    assert len(hdr) == head and len(names) == rec
    assert len(ints) == head + hdr["nl"] * rec
    layers = [dict(zip(names, ints[head + rec * l:head + rec * (l + 1)]))
              for l in range(hdr["nl"])]
    return hdr, layers


def _buf_row(off, nch, wb, par, h, c, w):
    return off // 16 + (h * nch + c) * wb + (w % par) * (wb // par) + w // par


def _chunk_row(q, L):
    nslot = L["k"] + L["p"] - 1
    slot, t = q % nslot, q // nslot
    c, kh = t % L["in_nch"], t // L["in_nch"]
    half = (nslot + 1) // 2
    kw = slot if L["in_par"] == 1 else (2 * slot if slot < half
                                        else 2 * (slot - half) + 1)
    return _buf_row(0, L["in_nch"], L["in_wb"], L["in_par"], kh, c, kw)


def _emulate_segment(x, weights, scales, offsets, seg, final_stride,
                     out_dtype):
    hdr, Ls = _fields(seg.ints)
    nb, H, W, ci0 = x.shape
    s_last = Ls[-1]["s"]
    Ho, Wo = -(-H // s_last), -(-W // s_last)
    xs = x.float().numpy()
    layers = range(seg.first, seg.last + 1)
    wcat = torch.cat(chain_weights(weights, seg, final_stride, ci0)) \
        .float().numpy()
    sc = torch.cat([scales[l].float() for l in layers]).numpy()
    of = torch.cat([offsets[l].float() for l in layers]).numpy()
    y = np.full((nb, Ho, Wo, Ls[-1]["co"]), np.nan)
    for n in range(nb):
        for by in range(-(-Ho // hdr["th"])):
            for bx in range(-(-Wo // hdr["tw"])):
                _emulate_block(xs[n], wcat, sc, of, hdr, Ls, y[n],
                               by * hdr["th"], bx * hdr["tw"], H, W, Ho, Wo)
    got = torch.from_numpy(y.astype(np.float32))
    return got.to(out_dtype)


def _emulate_block(x, wcat, sc, of, hdr, Ls, y, t0h, t0w, H, W, Ho, Wo):
    rows = np.full((hdr["smem"] // 16, 8), np.nan)     # 16-byte rows
    for L in Ls:   # every layer's weights as B's core matrices
        r = np.arange(L["q"] * L["n"])
        q, co = r // L["n"], r % L["n"]
        cols = L["p"] * L["co"]
        live = (co < cols) & (q < L["q_real"])
        src = (L["w_glob"] + (q * cols + co) * 8)[:, None] + np.arange(8)
        rows[L["w_smem"] // 16 + r] = np.where(
            live[:, None], wcat[np.where(live[:, None], src, 0)], 0.0)
    oxh, oxw = hdr["mx"] * t0h - hdr["cx"], hdr["mx"] * t0w - hdr["cx"]
    ci0 = hdr["ci0"]

    def pixel(ih, iw):
        inside = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
        return np.where(inside[..., None],
                        x[np.clip(ih, 0, H - 1), np.clip(iw, 0, W - 1)], 0.0)
    if hdr["head"]:
        lh, px = np.meshgrid(np.arange(hdr["x_hb"]), np.arange(hdr["x_w"]),
                             indexing="ij")
        vals = pixel(oxh + lh, oxw - hdr["shift"] + px)   # (hb, x_w, Ci)
        flat = rows.reshape(-1)
        flat[hdr["x_off"] // 2:hdr["x_off"] // 2 + vals.size] = vals.reshape(-1)
    else:
        lh, lw, c = np.meshgrid(np.arange(hdr["x_hb"]), np.arange(hdr["x_wb"]),
                                np.arange(hdr["x_nch"]), indexing="ij")
        vals = pixel(oxh + lh, oxw + lw)          # (hb, wb, nch, Ci)
        dst = _buf_row(hdr["x_off"], hdr["x_nch"], hdr["x_wb"], hdr["x_par"],
                       lh, c, lw)
        rows[dst] = vals[:, :, 0].reshape(*c.shape, 8)
    for l, L in enumerate(Ls):
        last, head = l == len(Ls) - 1, l == 0 and hdr["head"]
        P = L["p"]
        nbw = L["pw"] // (8 * P)
        nmb = L["ph"] // 8 * nbw
        mb = conv_kernel._CHAIN_MB
        mult = 1 if last else hdr["mx"]
        oh, ow = mult * t0h - L["c"], mult * t0w - L["c"]
        gh, gw = (Ho, Wo) if last else (H, W)
        steps = L["q"] // 2
        for b0 in range(0, nmb, 2 * mb):
            blocks = range(b0, min(b0 + 2 * mb, nmb))
            if head:
                flat = rows.reshape(-1)
                nslot = L["k"] + P - 1
                for bi, b in enumerate(blocks):
                    r = np.arange(64)
                    h, g = 8 * (b // nbw) + r // 8, 8 * (b % nbw) + r % 8
                    for kc in range(L["q"]):
                        kk = 8 * kc + np.arange(8)
                        tap, c = kk // ci0, kk % ci0
                        el = (hdr["x_off"] // 2
                              + ((L["s"] * h[:, None] + tap // nslot)
                                 * hdr["x_w"] + hdr["shift"]
                                 + L["s"] * P * g[:, None] + tap % nslot)
                              * ci0 + c)
                        v = np.where(tap < L["k"] * nslot, flat[np.where(
                            tap < L["k"] * nslot, el, 0)], 0.0)
                        rows[hdr["pack_off"] // 16 + (bi * L["q"] + kc) * 64
                             + r] = v
            for bi, b in enumerate(blocks):
                if head:
                    base = bi * L["q"] * 64
                else:
                    base = (L["s"] * 8 * (b // nbw) * L["in_nch"] * L["in_wb"]
                            + 8 * (b % nbw))
                m = np.arange(64)
                a = np.empty((64, 16 * steps))
                for st in range(steps):
                    if head:
                        start, lbo, sbo = (hdr["pack_off"] // 16 + 128 * st,
                                           64, 8)
                    else:
                        r0 = _chunk_row(2 * st, L)
                        r1 = (_chunk_row(2 * st + 1, L)
                              if 2 * st + 1 < L["q_real"] else r0)
                        start = L["in_off"] // 16 + r0
                        lbo, sbo = r1 - r0, L["s"] * L["in_nch"] * L["in_wb"]
                    for kk in range(2):
                        a[:, 16 * st + 8 * kk:16 * st + 8 * kk + 8] = rows[
                            start + base + (m // 8) * sbo + kk * lbo + m % 8]
                bq = rows[L["w_smem"] // 16 + np.arange(L["q"])[:, None]
                          * L["n"] + np.arange(L["n"])]      # (q, N, 8)
                bmat = bq.transpose(0, 2, 1).reshape(8 * L["q"], L["n"])
                acc = a @ bmat
                co = L["co"]
                for pp in range(P):    # the row's pp-th output along w
                    h = 8 * (b // nbw) + m // 8
                    w = P * (8 * (b % nbw) + m % 8) + pp
                    v = acc[:, pp * co:(pp + 1) * co] \
                        * sc[L["so"]:L["so"] + co] + of[L["so"]:L["so"] + co]
                    if L["relu"]:
                        v = np.maximum(v, 0.0)
                    if L["res"] >= 0:
                        rr = _buf_row(L["rb_off"], L["rb_nch"], L["rb_wb"],
                                      L["rb_par"], (h + L["res_dc"])[:, None],
                                      np.arange(co // 8)[None],
                                      (w + L["res_dc"])[:, None])
                        v = v + rows[rr].reshape(64, co)
                    ih, iw = oh + h, ow + w
                    inside = (ih >= 0) & (ih < gh) & (iw >= 0) & (iw < gw)
                    if last:
                        keep = inside & (h < L["eh"]) & (w < L["ew"])
                        y[ih[keep], iw[keep]] = v[keep]
                    else:
                        dst = _buf_row(L["out_off"], L["out_nch"],
                                       L["out_wb"], L["out_par"], h[:, None],
                                       np.arange(co // 8)[None], w[:, None])
                        rows[dst] = _bf16(np.where(inside[:, None], v, 0.0)) \
                            .reshape(64, co // 8, 8)


def _emulate(x, weights, scales, offsets, relus, residuals, final_stride,
             plan, out_dtype=torch.bfloat16):
    """The plan's segments as the kernel runs them, and a layer that no
    segment takes by its plain conv (the per-layer launch it gets)."""
    segments = {seg.first: seg for seg in plan}
    v, l, nl = x, 0, len(weights)
    while l < nl:
        last = l == nl - 1
        if l in segments:
            seg = segments[l]
            end = seg.last == nl - 1
            v = _emulate_segment(v, weights, scales, offsets, seg,
                                 final_stride if end else 1,
                                 out_dtype if end else x.dtype)
            l = seg.last + 1
            continue
        assert residuals[l] is None
        v = _conv_plain(v, weights[l], scales[l], offsets[l],
                        stride=final_stride if last else 1, relu=relus[l],
                        residual=None, out_dtype=out_dtype if last else x.dtype)
        l += 1
    return v


def _plain(x, ws, scales, offsets, relus, residuals, final_stride):
    return conv2d_chain(x, ws, scales, offsets, relu_flags=relus,
                        residuals=residuals, final_stride=final_stride,
                        plain=True)


def _agree(got, ref, tol=BF16_TOL):
    assert got.shape == ref.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("name", list(DTU_CHAINS))
def test_plan_fits_the_shared_memory_at_every_dtu_chain(name):
    """Every chain of the DTU forward either has a one-launch plan whose
    blocks fit two to an SM in shared memory, or the kernel takes no such
    chain (the 64-channel pair: Co > 32); the written rule sends the trunk
    (one launch for its first two layers at its 32 x 64 tile, where the
    whole chain does not fit; its stride-2 tail by conv_route) and the
    16-channel pair to the chain kernel, every other chain, and every f32
    chain, to the per-layer route."""
    specs, relus, res, fs, _ = DTU_CHAINS[name]
    plan = chain_plan(specs, relus, res, fs, TILES[name])
    route = chain_route(torch.bfloat16, specs, relus, res, fs)
    assert route == ("fused" if name in ("trunk", "x2") else "layers")
    assert chain_route(torch.float32, specs, relus, res, fs) == "layers"
    if name == "x4":
        assert plan is None
        return
    assert [(g.first, g.last) for g in plan] == [(0, len(specs) - 1)]
    # a launch's blocks fit two to an SM (228 KB, 1 KB a block)
    assert conv_kernel._CHAIN_SMEM * 2 + 2048 <= 228 * 1024
    assert all(0 < seg.smem <= conv_kernel._CHAIN_SMEM for seg in plan)
    if route == "fused":
        rule = chain_plan(specs, relus, res, fs,
                          conv_kernel.CHAIN_FUSED[specs, relus, res, fs])
        assert [(g.first, g.last) for g in rule] == [(0, 1)]
        assert all(0 < seg.smem <= conv_kernel._CHAIN_SMEM for seg in rule)


@pytest.mark.parametrize("name", ["trunk", "x2", "x3", "refine"])
def test_plan_covers_every_output_once(name):
    """The kernel's grid of th x tw tiles, each storing its positions that
    the last layer needs and that lie in the image, covers every output
    pixel exactly once (H, W at DTU and odd extents)."""
    specs, relus, res, fs, shape = DTU_CHAINS[name]
    (seg,) = chain_plan(specs, relus, res, fs, TILES[name])
    for h, w in (shape[1:3], (37, 53)):
        ho, wo = -(-h // fs), -(-w // fs)
        count = np.zeros((ho, wo), np.int64)
        eh, ew = seg.needs[-1]
        for t0h in range(0, ho, seg.th):
            for t0w in range(0, wo, seg.tw):
                count[t0h:t0h + eh, t0w:t0w + ew] += 1
        assert (count == 1).all()
        assert seg.regions[-1] == seg.needs[-1] == (seg.th, seg.tw)


@pytest.mark.parametrize("name", ["trunk", "x2", "refine"])
def test_plan_regions_are_the_later_pads(name):
    """Each layer's region is the final tile plus twice the sum of the later
    layers' pads (a stride-2 tail doubles what precedes it), padded to
    whole M blocks."""
    specs, relus, res, fs, _ = DTU_CHAINS[name]
    (seg,) = chain_plan(specs, relus, res, fs, TILES[name])
    pads = [k // 2 for k, _, _ in specs]
    for l in range(len(specs) - 1):
        later = sum(pads[l + 1:-1]) if fs == 2 else sum(pads[l + 1:])
        want = tuple(fs * (t - 1) + specs[-1][0] + 2 * later if fs == 2
                     else t + 2 * later for t in (seg.th, seg.tw))
        assert seg.needs[l] == want
        # M blocks: 8 rows x 8 GEMM rows along w of chain_outputs each
        p = chain_outputs(1, specs[l][2])
        assert seg.regions[l] == (-(-want[0] // 8) * 8,
                                  -(-want[1] // (8 * p)) * 8 * p)


@pytest.mark.parametrize("c,tile", [(32, (8, 8)), (16, (16, 32))])
def test_plan_cuts_segments_where_no_skip_crosses(c, tile):
    """A chain too large for one launch is cut into segments of at least
    two layers before a layer over which no residual skips, each the
    longest that fits."""
    specs = ((3, c, c),) * 8
    relus = (True,) * 8
    res = (None, None, 1, None, None, None, 5, None)
    plan = chain_plan(specs, relus, res, 1, tile)
    assert plan is not None and len(plan) > 1
    assert all(seg.last > seg.first for seg in plan)
    cuts = [seg.first for seg in plan[1:]]
    assert all(not (j is not None and j < c <= m)
               for c in cuts for m, j in enumerate(res))
    assert plan[0].first == 0 and plan[-1].last == 7
    assert all(a.last + 1 == b.first for a, b in zip(plan, plan[1:]))
    for a in plan[:-1]:   # the next layer would not have fitted
        sub = slice(a.first, a.last + 2)
        longer = chain_plan(specs[sub], relus[sub],
                            tuple(None if j is None else j - a.first
                                  for j in res[sub]), 1, tile)
        assert longer is None or longer[0].last < a.last + 1 - a.first or \
            any(j is not None and j < a.last + 2 <= m
                for m, j in enumerate(res))
    rng = np.random.RandomState(3)
    x, ws, sc, of = _chain_args(rng, specs, (1, 13, 21, c))
    _agree(_emulate(x, ws, sc, of, relus, res, 1, plan),
           _plain(x, ws, sc, of, relus, res, 1))


def test_plan_leaves_a_layer_that_starts_no_segment_to_conv_route():
    """No segment holds one layer: where the trunk's three layers do not
    fit (its 32 x 64 tile in CHAIN_FUSED) the first two take one launch
    and the stride-2 tail none; a lone layer with a skip over its end, or
    a chain of one layer, has no plan."""
    specs, relus, res, fs, _ = TRUNK
    plan = chain_plan(specs, relus, res, fs, (32, 64))
    assert [(g.first, g.last) for g in plan] == [(0, 1)]
    assert plan[0].needs[-1] == plan[0].regions[-1] == (32, 64)
    assert chain_plan(((3, 8, 8),), (True,), (None,), 1, (16, 16)) is None
    # Co = 64 takes no segment: the first and last layers go alone
    specs = ((3, 8, 64), (3, 64, 16), (3, 16, 16), (3, 16, 64))
    plan = chain_plan(specs, (True,) * 4, (None,) * 4, 1, (8, 16))
    assert [(g.first, g.last) for g in plan] == [(1, 2)]
    assert chain_plan(specs, (True,) * 4, (None, None, None, 0), 1,
                      (8, 16)) is None
    rng = np.random.RandomState(4)
    x, ws, sc, of = _chain_args(rng, specs, (1, 11, 19, 8))
    _agree(_emulate(x, ws, sc, of, (True,) * 4, (None,) * 4, 1, plan),
           _plain(x, ws, sc, of, (True,) * 4, (None,) * 4, 1))


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 2), (1, 1)])
def test_chain_weights_with_one_output_a_row_are_the_tc_order(k, stride):
    """pack_chain_weight with one output a row packs what pack_tc_weight
    packs (the tc kernel's K order); with two (N = 16) each output's half
    holds the taps shifted by its window column."""
    rng = np.random.RandomState(9)
    w = torch.from_numpy(rng.randn(8, 16, k, k).astype(np.float32))
    assert torch.equal(pack_chain_weight(w, stride=stride),
                       pack_tc_weight(w.permute(2, 3, 1, 0), kd=1, k=k,
                                      stride=stride))
    if stride == 1:
        two = pack_chain_weight(w, stride=1, p=2).float().view(
            k, 2, k + 1, 16, 8)     # (kh, c, slot, col, j), slots 0 2 1 3..
        order = list(range(0, k + 1, 2)) + list(range(1, k + 1, 2))
        for slot, kw in enumerate(order):
            for pp in range(2):
                tap = kw - pp
                want = (w[:, :, :, tap].permute(2, 1, 0).reshape(k, 2, 8, 8)
                        .permute(0, 1, 3, 2) if 0 <= tap < k
                        else torch.zeros(k, 2, 8, 8))
                got = two[:, :, slot, 8 * pp:8 * pp + 8]
                assert torch.equal(got, want.to(torch.bfloat16).float())


def test_plan_refuses_what_the_kernel_does_not_take():
    two = (True,) * 2, (None,) * 2, 1, (16, 16)
    assert chain_plan(((3, 8, 64), (3, 64, 64)), *two) is None     # Co > 32
    assert chain_plan(((3, 4, 8), (3, 8, 8)), *two) is None        # Ci = 4
    assert chain_plan(((3, 8, 8), (3, 8, 8)), (True,) * 2,
                      (None, 0), 2, (16, 16)) is None   # a skip into stride 2
    assert chain_plan(((3, 8, 8), (3, 8, 8)), *two[:3], (12, 16)) is None


# ------------------------------------------------------------ the head

@pytest.mark.parametrize("ci,stride,p", [(3, 1, 1), (1, 1, 1), (3, 2, 1),
                                         (3, 1, 2), (1, 1, 2)])
def test_packed_head_gemm_equals_the_plain_conv(ci, stride, p):
    """The head's packed GEMM, as the kernel gathers and multiplies it,
    equals the plain conv (both f32 sums of the same bf16 products): one
    output a row, K = 32 (Ci = 3) or 16 (Ci = 1); two outputs a row (the
    chain's 3 -> 8 and 1 -> 8 heads), a window of 4 columns, K = 48 or 16
    and N = 16."""
    rng = np.random.RandomState(40 + ci)
    x = torch.from_numpy(rng.randn(2, 11, 17, ci).astype(np.float32)) \
        .to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(8, ci, 3, 3) * 0.3).astype(np.float32)) \
        .to(torch.bfloat16)
    scale = torch.from_numpy((0.5 + rng.rand(8)).astype(np.float32))
    offset = torch.from_numpy(rng.randn(8).astype(np.float32))
    packed = pack_head_weight(w, p)
    assert packed.shape == (head_chunks(3, ci, p), 8 * p, 8) == (
        {(3, 1): 4, (1, 1): 2, (3, 2): 6, (1, 2): 2}[ci, p], 8 * p, 8)
    got = chain_head_plain(x, packed, scale, offset, k=3, stride=stride,
                           relu=True, out_dtype=torch.float32, p=p)
    want = _conv_plain(x, w, scale, offset, stride=stride, relu=True,
                       residual=None, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ------------------------------------------------------------ the emulated kernel

@pytest.mark.parametrize("name,shape,tile", [
    ("trunk", (2, 37, 53, 3), None), ("trunk", (1, 24, 32, 3), (8, 8)),
    ("trunk", (2, 37, 53, 3), (32, 64)), ("trunk", (1, 40, 72, 3), (32, 32)),
    ("refine", (1, 29, 43, 1), None), ("refine", (1, 16, 40, 1), (8, 16)),
    ("x2", (2, 21, 35, 16), None), ("x3", (1, 19, 27, 32), None)])
def test_emulated_kernel_matches_the_plain_chain(name, shape, tile):
    """The chain kernel's plan, executed as the kernel executes it, against
    the plain chain: odd and even extents, partial tiles at the right and
    bottom edges, a W that is a multiple of 8 (the raw head rows' 16-byte
    copies) and one that is not; at the trunk's tile in CHAIN_FUSED its
    tail by the plain conv."""
    specs, relus, res, fs, _ = DTU_CHAINS[name]
    plan = chain_plan(specs, relus, res, fs, tile or TILES[name])
    rng = np.random.RandomState(sum(shape))
    x, ws, sc, of = _chain_args(rng, specs, shape)
    _agree(_emulate(x, ws, sc, of, relus, res, fs, plan),
           _plain(x, ws, sc, of, relus, res, fs))


def test_emulated_kernel_f32_output_and_a_skip_into_the_last_layer():
    """A one-layer head segment writing f32 (the form of chip_smoke.py's
    sum-accuracy check, which launches it alone), and a chain whose last
    layer adds a skip."""
    rng = np.random.RandomState(5)
    specs = ((3, 3, 8),)
    plan = (conv_kernel._chain_segment(specs, (False,), (None,), 1, 16, 32)
            ._replace(first=0, last=0),)
    x, ws, sc, of = _chain_args(rng, specs, (1, 13, 19, 3))
    _agree(_emulate(x, ws, sc, of, (False,), (None,), 1, plan,
                    torch.float32),
           conv2d_chain(x, ws, sc, of, relu_flags=(False,), plain=True,
                        out_dtype=torch.float32), 1e-4)
    specs = ((3, 8, 8), (3, 8, 8), (3, 8, 8))
    res = (None, None, 0)
    plan = chain_plan(specs, (True,) * 3, res, 1, (16, 16))
    x, ws, sc, of = _chain_args(rng, specs, (1, 15, 22, 8))
    _agree(_emulate(x, ws, sc, of, (True,) * 3, res, 1, plan),
           _plain(x, ws, sc, of, (True,) * 3, res, 1))


# ------------------------------------------------------------ vs the TPU kernel

def _pad_ci(k, ci):
    """Zero input channels up to 8 (the Pallas chain's f32 DMA alignment)."""
    return np.pad(k, ((0, 0), (0, 0), (0, 8 - ci), (0, 0)))


@pytest.mark.parametrize("name", ["trunk", "refine"])
def test_plain_chain_matches_pallas_at_dtu_chain_forms(name):
    """The plain chain vs ``conv2d_chain_fused`` (interpret mode, f32) for
    the trunk (3 -> 8 -> 8 -> 16, 5x5 stride-2 tail) and refine's stack (1
    -> 8, three Res blocks, conv1 plus the long skip of conv0, 8 -> 32) at
    small odd extents; the Pallas kernel takes Ci padded to 8 with zeros."""
    specs, relus, res, fs, _ = DTU_CHAINS[name]
    rng = np.random.RandomState(80 + len(specs))
    n, h, w = 1, 13, 19
    ci = specs[0][1]
    x = rng.randn(n, h, w, ci).astype(np.float32)
    ks = [(rng.randn(k, k, i, o) * (1.0 / (k * i ** 0.5))).astype(np.float32)
          for k, i, o in specs]
    scales = [(0.5 + rng.rand(o)).astype(np.float32) for _, _, o in specs]
    offsets = [(0.1 * rng.randn(o)).astype(np.float32) for _, _, o in specs]
    got = conv2d_chain(torch.from_numpy(x),
                       [torch.from_numpy(np.ascontiguousarray(
                           np.moveaxis(k, (-1, -2), (0, 1)))) for k in ks],
                       [torch.from_numpy(s) for s in scales],
                       [torch.from_numpy(o) for o in offsets],
                       relu_flags=relus, residuals=res,
                       final_stride=fs).numpy()
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 8 - ci)))
    pallas = conv2d_chain_fused(
        jnp.asarray(xp.transpose(0, 1, 3, 2)),
        [jnp.asarray(_pad_ci(ks[0], ci))] + [jnp.asarray(k) for k in ks[1:]],
        [jnp.asarray(s) for s in scales], [jnp.asarray(o) for o in offsets],
        th=4, relu_flags=relus, residuals=res, final_stride=fs,
        interpret=True)
    want = np.asarray(pallas).transpose(0, 1, 3, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cpu_chain_launches_nothing():
    """On the CPU the chain takes its plain version whatever the route: no
    build, no counter moves."""
    before = dict(conv_kernel.LAUNCHES)
    specs, relus, res, fs, _ = TRUNK
    x, ws, sc, of = _chain_args(np.random.RandomState(1), specs,
                                (1, 8, 12, 3))
    conv2d_chain(x, ws, sc, of, relu_flags=relus, residuals=res,
                 final_stride=fs, route="fused")
    assert conv_kernel.LAUNCHES == before
