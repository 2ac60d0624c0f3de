"""The splat kernel's plan (K7, ``csrc/splat_2d.cu``) on the CPU.

The kernel has no CPU mode, so this file emulates its two passes in numpy
on ``splat_kernel.splat_plan``: the bin pass (per chunk of samples a count
per tile, the scans, and the scatter whose ranks come from the warps'
rounds of 32 lanes) and the reduce pass (per tile, chunks of samples
sorted stably into the base cells by per-warp counts, each sample
written into its pixels' lists at its rank among their 4 cells' samples;
the samples whose taps have weight 0, snapped to -1, only where their
value is not finite).
It holds the plan to what the kernel relies on: every in-image (sample, tap) term is taken once, each pixel
takes its terms in ascending sample order, so its sequential f32 sum is
that order's bit for bit (the order of the sort-based kernel that K7
replaced), and the result agrees with ``splat_2d_plain``; at odd extents,
on a stress camera, with empty tiles and with every coordinate outside the
image; and with the TPU kernel in interpret mode where its contract holds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdfnet_tpu.ops.pallas.splat_kernel import pallas_splat_2d
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops.cuda.splat_kernel import (BIN_CHUNK, REDUCE_SMEM,
                                                    TILE_W, SplatPlan,
                                                    reduce_smem, splat_plan)
from mdfnet_tpu_torch.ops.splat import splat_2d_plain

F32 = np.float32
# |emulation - plain| / max|plain| (f32: the orders differ)
REL_TOL = 1e-5


def _snapped(x, y, h, w):
    """splat_2d.cu snapped: bilinear_taps snaps x or y to -1."""
    return ~((x > -1.0) & (x < w)) | ~((y > -1.0) & (y < h))


def _taps(x, y, h, w):
    """common.cuh bilinear_taps in f32: (x0, y0, wx, wy)."""
    x = np.where((x > -1.0) & (x < w), x, F32(-1.0)).astype(F32)
    y = np.where((y > -1.0) & (y < h), y, F32(-1.0)).astype(F32)
    x0, y0 = np.floor(x), np.floor(y)
    return (x0.astype(np.int64), y0.astype(np.int64), (x - x0).astype(F32),
            (y - y0).astype(F32))


def _sample_tiles(x0, y0, h, w, plan: SplatPlan):
    """splat_2d.cu sample_tiles: each sample's 4 tile slots and the mask of
    those that are tiles of their own."""
    tw, th = TILE_W, plan.tile_h
    tx0, tx1 = np.maximum(x0, 0) // tw, np.minimum(x0 + 1, w - 1) // tw
    ty0, ty1 = np.maximum(y0, 0) // th, np.minimum(y0 + 1, h - 1) // th
    slots = np.stack([ty0 * plan.tiles_x + tx0, ty0 * plan.tiles_x + tx1,
                      ty1 * plan.tiles_x + tx0, ty1 * plan.tiles_x + tx1], -1)
    dx, dy = tx1 != tx0, ty1 != ty0
    valid = np.stack([np.ones_like(dx), dx, dy, dx & dy], -1)
    return slots, valid


def _warp_rounds(slots, valid):
    """for_each_tile over one round of up to 32 lanes: (lane, tile, rank
    among the round's lanes of that tile) in the kernel's visiting order."""
    pending = valid.copy()
    out = []
    while pending.any():
        leader = int(np.flatnonzero(pending.any(-1))[0])
        x = slots[leader][np.flatnonzero(pending[leader])[0]]
        hit = pending & (slots == x)
        lanes = np.flatnonzero(hit.any(-1))
        out += [(int(lane), int(x), r) for r, lane in enumerate(lanes)]
        pending &= ~hit
    return out


def bin_pass(x, y, h, w, plan: SplatPlan):
    """The count, scan and bin kernels: (entries, starts)."""
    b, n = x.shape
    x0, y0, _, _ = _taps(x, y, h, w)
    slots, valid = _sample_tiles(x0, y0, h, w, plan)
    valid &= ~_snapped(x, y, h, w)[..., None]      # in no bin
    counts = np.zeros((b, plan.tiles, plan.chunks), np.int64)
    for bi in range(b):
        for ck in range(plan.chunks):
            s = slice(ck * plan.chunk, min(n, (ck + 1) * plan.chunk))
            np.add.at(counts[bi, :, ck], slots[bi, s][valid[bi, s]], 1)
    totals = counts.sum(-1).reshape(-1)
    starts = np.concatenate([[0], np.cumsum(totals)])
    offsets = np.cumsum(counts, -1) - counts            # scan_rows: exclusive
    entries = np.full(plan.entries, -1, np.int64)
    per_warp = plan.chunk // 8
    for bi in range(b):
        for ck in range(plan.chunks):
            base = ck * plan.chunk
            warp_runs = []
            for wp in range(8):        # pass A: each warp's count per tile
                cnt = {}
                for s0 in range(base + wp * per_warp,
                                base + (wp + 1) * per_warp, 32):
                    lanes = np.arange(s0, min(s0 + 32, n))
                    for _, t, _ in _warp_rounds(slots[bi, lanes],
                                                valid[bi, lanes]):
                        cnt[t] = cnt.get(t, 0) + 1
                warp_runs.append(cnt)
            nxt = [{} for _ in range(8)]    # each warp's first slot per tile
            for t in set().union(*warp_runs):
                run = starts[bi * plan.tiles + t] + offsets[bi, t, ck]
                for wp in range(8):
                    nxt[wp][t] = run
                    run += warp_runs[wp].get(t, 0)
            for wp in range(8):        # pass B: write at slot + rank
                for s0 in range(base + wp * per_warp,
                                base + (wp + 1) * per_warp, 32):
                    lanes = np.arange(s0, min(s0 + 32, n))
                    seen = {}
                    for lane, t, r in _warp_rounds(slots[bi, lanes],
                                                   valid[bi, lanes]):
                        entries[nxt[wp][t] + r] = bi * n + lanes[lane]
                        seen[t] = seen.get(t, 0) + 1
                    for t, c in seen.items():
                        nxt[wp][t] += c
    return entries, starts


def reduce_pass(g, x, y, h, w, plan: SplatPlan, entries, starts):
    """The reduce kernel for every tile: (out (B, h, w, C) f32, each
    pixel's terms as [(flat sample, tap), ...] in the order it added
    them)."""
    b, n, c = g.shape
    gf, xf, yf = g.reshape(-1, c), x.reshape(-1), y.reshape(-1)
    tw, th, chunk = TILE_W, plan.tile_h, plan.reduce_chunk
    pix, cw, rounds = tw * th, tw + 1, chunk // 256   # 8 warps of 32 lanes
    cells = cw * (th + 1)
    out = np.zeros((b, h, w, c), F32)
    terms = {}
    for bt in range(b * plan.tiles):
        bi, tile = divmod(bt, plan.tiles)
        ox, oy = tile % plan.tiles_x * tw, tile // plan.tiles_x * th
        acc = np.zeros((pix, c), F32)
        for k0 in range(starts[bt], starts[bt + 1], chunk):
            m = min(chunk, starts[bt + 1] - k0)
            idx = entries[k0:k0 + m]
            assert (idx >= 0).all()
            x0, y0, wx, wy = _taps(xf[idx], yf[idx], h, w)
            cell = (y0 - oy + 1) * cw + (x0 - ox + 1)
            assert ((cell >= 0) & (cell < cells)).all()
            # j = (warp * rounds + round) * 32 + lane
            warp = np.arange(m) // (rounds * 32)
            hist = np.zeros((8, cells), np.int64)
            np.add.at(hist, (warp, cell), 1)
            first = (np.cumsum(hist.T.reshape(-1)) - hist.T.reshape(-1)
                     ).reshape(cells, 8)            # scan over (cell, warp)
            cstart = np.append(first[:, 0], m)
            slot = np.empty(m, np.int64)
            for j in range(m):          # rounds in order: the match ranks
                slot[j] = first[cell[j], warp[j]]
                first[cell[j], warp[j]] += 1
            lst = np.empty(m, np.int64)
            lst[slot] = np.arange(m)
            rank = slot - cstart[cell]
            # each pixel's count: its 4 cells; an exclusive scan over the
            # pixels in thread order (thread t: rows t // 32 + 8 q of column
            # t % 32); pidx maps a pixel (row-major) to its place there
            t, q = np.divmod(np.arange(pix), th // 8)
            py, px = t // 32 + 8 * q, t % 32
            c0 = (py + 1) * cw + px + 1
            size = np.diff(cstart)
            inside = (ox + px < w) & (oy + py < h)
            cnt = np.where(inside, size[c0 - 1] + size[c0] + size[c0 - cw - 1]
                           + size[c0 - cw], 0)
            pstart = np.append(np.cumsum(cnt) - cnt, cnt.sum())
            pidx = np.empty(pix, np.int64)
            pidx[py * tw + px] = np.arange(pix)
            lists = np.full(pstart[-1], -1, np.int64)
            for j in range(m):
                bx, by = cell[j] % cw - 1, cell[j] // cw - 1
                for k in range(4):
                    qx, qy = bx + (k & 1), by + (k >> 1)
                    if not (0 <= qx < tw and 0 <= qy < th and ox + qx < w
                            and oy + qy < h):
                        continue
                    q0 = (qy + 1) * cw + qx + 1
                    at = rank[j]
                    for k2 in range(4):
                        if k2 != k:
                            cc = q0 - (k2 & 1) - (k2 >> 1) * cw
                            run = lst[cstart[cc]:cstart[cc + 1]]
                            at += int(np.searchsorted(run, j))
                    e = pstart[pidx[qy * tw + qx]] + at
                    assert lists[e] == -1
                    lists[e] = j << 2 | k
            assert (lists >= 0).all()
            for p in np.flatnonzero(inside[pidx]):
                i = pidx[p]
                for jk in lists[pstart[i]:pstart[i + 1]]:
                    j, k = jk >> 2, jk & 3
                    fx = wx[j] if k & 1 else F32(1.0) - wx[j]
                    fy = wy[j] if k >> 1 else F32(1.0) - wy[j]
                    acc[p] = acc[p] + (gf[idx[j]] * fy).astype(F32) * fx
                    terms.setdefault((bi, oy + p // tw, ox + p % tw),
                                     []).append((int(idx[j]), int(k)))
        for p in range(pix):
            qy, qx = oy + p // tw, ox + p % tw
            if qx < w and qy < h:
                out[bi, qy, qx] = acc[p]
    # splat_nan_kernel: a snapped sample's non-finite values are NaN at its
    # in-image taps
    x0, y0, _, _ = _taps(xf, yf, h, w)
    for i in np.flatnonzero(_snapped(xf, yf, h, w)):
        bad = ~np.isfinite(gf[i])
        for k in range(4):
            xi, yi = x0[i] + (k & 1), y0[i] + (k >> 1)
            if bad.any() and 0 <= xi < w and 0 <= yi < h:
                out[i // n, yi, xi, bad] = np.nan
    return out, terms


def emulate(g, x, y, h, w):
    b, n = x.shape
    plan = splat_plan(b, n, h, w, g.shape[-1], g.itemsize)
    entries, starts = bin_pass(x, y, h, w, plan)
    return plan, entries, starts, *reduce_pass(g, x, y, h, w, plan, entries,
                                               starts)


def _all_terms(x, y, h, w):
    """Every in-image (sample, tap) term per pixel, in ascending (sample,
    tap) order: the sort-based kernel's order."""
    b, n = x.shape
    x0, y0, _, _ = _taps(x, y, h, w)
    terms = {}
    for i in range(b * n):
        bi = i // n
        for k in range(4):
            xi, yi = x0.flat[i] + (k & 1), y0.flat[i] + (k >> 1)
            if 0 <= xi < w and 0 <= yi < h:
                terms.setdefault((bi, int(yi), int(xi)), []).append((i, k))
    return terms


def _sequential(g, x, y, h, w):
    """Each pixel's f32 sum of every in-image term (v * fy) * fx in
    ascending (sample, tap) order: the sort-based kernel's sum."""
    b, n, c = g.shape
    x0, y0, wx, wy = _taps(x, y, h, w)
    gf = g.reshape(-1, c)
    ref = np.zeros((b, h, w, c), F32)
    with np.errstate(invalid="ignore"):
        for (bi, yi, xi), ts in _all_terms(x, y, h, w).items():
            acc = np.zeros(c, F32)
            for i, k in ts:
                fx = wx.flat[i] if k & 1 else F32(1.0) - wx.flat[i]
                fy = wy.flat[i] if k >> 1 else F32(1.0) - wy.flat[i]
                acc = acc + (gf[i] * fy).astype(F32) * fx
            ref[bi, yi, xi] = acc
    return ref


def _coords(case, rng):
    """(x, y) (B, N) f32 and the extent of each case."""
    if case.startswith(("odd", "stress")):
        h, w, d, v = (37, 45, 3, 3) if case != "stress" else (20, 36, 6, 3)
        yaw = 0.35 if case == "stress" else 0.0
        k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2],
                          [0, 0, 1]])
        e = torch.eye(4).repeat(v, 1, 1)
        e[:, 0, 3] = -torch.arange(v) * 12.0
        for i in range(v):
            cs, sn = np.cos(i * yaw), np.sin(i * yaw)
            e[i, 0, 0], e[i, 0, 2], e[i, 2, 0], e[i, 2, 2] = cs, sn, -sn, cs
        ref, src = geometry.projection_matrices(k.repeat(1, v, 1, 1), e[None],
                                                stage=3)
        hyp = torch.linspace(*((40, 5000) if yaw else (425, 935)), d)
        x, y = geometry.sweep_coordinates(
            src[0], ref.expand(v - 1, 4, 4),
            hyp.reshape(1, d, 1, 1).expand(v - 1, d, 1, 1), h, w)
        x, y = geometry.reference_grid_coords(x, y, h, w)
        return x.reshape(v - 1, -1).numpy(), y.reshape(v - 1, -1).numpy(), h, w
    h, w, n = 40, 70, 1500
    if case == "empty tiles":   # only the first tile column and row band
        x = rng.uniform(-1.5, 20.0, (2, n))
        y = rng.uniform(-1.5, 12.0, (2, n))
    else:                       # "all outside": every coordinate snaps to -1
        x = np.concatenate([rng.uniform(-50, -1, (2, n // 2)),
                            rng.uniform(w, w + 50, (2, n - n // 2))], 1)
        y = rng.uniform(-30, h + 30, (2, n))
    return x.astype(F32), y.astype(F32), h, w


# name -> channels: 8, 16 and 32 channels take the three tile shapes (32 x
# 32, 32 x 16, 32 x 8); each case's images take several bin chunks
# (BIN_CHUNK), and a tile several reduce chunks
CASES = {"odd": 8, "odd c16": 16, "odd c32": 32, "stress": 16,
         "empty tiles": 8, "all outside": 8}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_takes_every_term_once_in_sample_order(case):
    rng = np.random.RandomState(5)
    x, y, h, w = _coords(case, rng)
    c = CASES[case]
    g = rng.randn(*x.shape, c).astype(F32)
    plan, entries, starts, out, terms = emulate(g, x, y, h, w)
    assert plan.chunk == BIN_CHUNK and plan.chunks > 1
    assert starts[-1] <= plan.entries
    assert plan.channels == c and plan.tile_h * c == 256
    # each bin holds its samples once, in ascending order
    for bt in range(len(starts) - 1):
        run = entries[starts[bt]:starts[bt + 1]]
        assert (np.diff(run) > 0).all()
    if case != "all outside":
        sizes = np.diff(starts)
        assert sizes.max() > plan.reduce_chunk      # a tile of several chunks
    if case == "empty tiles":
        assert (np.diff(starts) == 0).any()
    want = _all_terms(x, y, h, w)
    # every term of a sample that is not snapped once, in ascending (n,
    # tap); the snapped samples' terms, of weight 0, in no list
    snap = _snapped(x, y, h, w).reshape(-1)
    kept = {p: [t for t in ts if not snap[t[0]]] for p, ts in want.items()}
    assert terms == {p: ts for p, ts in kept.items() if ts}
    if case in ("odd", "stress", "all outside"):
        assert snap.any()
    # so the sum is the sequential f32 sum of every term, snapped ones
    # included, in that order, bit for bit
    ref = _sequential(g, x, y, h, w)
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32))
    plain = splat_2d_plain(torch.from_numpy(g[..., None, :]),
                           torch.from_numpy(x[..., None]),
                           torch.from_numpy(y[..., None]), h, w).numpy()
    err = np.abs(out - plain).max()
    assert err <= REL_TOL * max(np.abs(plain).max(), 1e-6)
    if case == "all outside":
        assert not out.any()


def test_plan_gives_nan_where_a_snapped_sample_is_not_finite():
    """A snapped sample's terms are (v * wy) * 0: NaN where its value is
    infinite or NaN. splat_nan_kernel puts NaN there, as the sequential sum
    of every term has it. (The plain version also adds the out-of-image
    taps' v * 0 at a clamped pixel, so it is no reference for values that
    are not finite.)"""
    rng = np.random.RandomState(7)
    x, y, h, w = _coords("odd", rng)
    g = rng.randn(*x.shape, 8).astype(F32)
    snap = np.flatnonzero(_snapped(x, y, h, w).reshape(-1))
    inner = np.flatnonzero(~_snapped(x, y, h, w).reshape(-1))
    gf = g.reshape(-1, 8)
    gf[snap[::5], 3] = np.inf
    gf[snap[1::7], 6] = np.nan
    gf[inner[::97], 1] = -np.inf
    with np.errstate(invalid="ignore"):
        *_, out, _ = emulate(g, x, y, h, w)
    ref = _sequential(g, x, y, h, w)
    assert np.isnan(out[..., 3]).any() and np.isnan(out[..., 6]).any()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.array_equal(out[ok].view(np.uint32), ref[ok].view(np.uint32))


def test_plan_matches_the_tpu_kernel():
    """At a camera where the TPU kernel's row band and x window hold, the
    emulated plan gives what pallas_splat_2d gives in interpret mode."""
    rng = np.random.RandomState(6)
    x, y, h, w = _coords("odd", rng)
    b, d = x.shape[0], 3
    g = rng.randn(b, d, h, w, 16).astype(F32)
    *_, out, _ = emulate(g.reshape(b, -1, 16), x, y, h, w)
    want, cover = pallas_splat_2d(
        jnp.asarray(g), jnp.asarray(x.reshape(b, d, h, w)),
        jnp.asarray(y.reshape(b, d, h, w)), h, w, band=8, x_margin=16,
        interpret=True)
    assert bool(cover)
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("shape", [(16, 48, 64, 80, 32), (16, 24, 128, 160, 16),
                                   (16, 8, 256, 320, 8), (2, 3, 37, 45, 24)])
def test_plan_at_the_train_stages(shape):
    """The DTU train stages' plans (and 24 channels: three blocks of 8 a
    tile): tiles, chunks and the bins' room; a reduce block's shared memory
    (csrc/splat_2d.cu reduce_smem) lets 3 blocks share an SM (228 KB, 1 KB
    of it reserved a block), as its launch bounds ask."""
    b, d, h, w, c = shape
    cpt = min(c & -c, 32)
    for size in (2, 4):
        plan = splat_plan(b, d * h * w, h, w, c, size)
        assert plan.channels == cpt and plan.tile_h == 256 // cpt
        assert plan.tiles_x * TILE_W >= w > (plan.tiles_x - 1) * TILE_W
        assert plan.tiles_y * plan.tile_h >= h > (plan.tiles_y - 1) * plan.tile_h
        assert plan.chunks * plan.chunk >= d * h * w
        assert plan.entries == 4 * b * d * h * w
        # as many samples a thread (at most 4) as keep 3 blocks an SM
        rs = plan.reduce_chunk // 256
        assert 1 <= rs <= 4
        assert reduce_smem(rs, cpt, size) <= REDUCE_SMEM
        assert rs == 4 or reduce_smem(rs + 1, cpt, size) > REDUCE_SMEM
        assert 3 * (REDUCE_SMEM + 1024) <= 228 * 1024


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        splat_plan(1, 10, 8, 8, 12, 4)
    with pytest.raises(ValueError):
        splat_plan(1, 10, 4000, 2000, 32, 2)   # 63 x 500 tiles > MAX_TILES
