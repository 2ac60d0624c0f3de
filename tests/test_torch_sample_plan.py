"""K6's plan (``warp_kernel.sample_plan``) and an emulation of its kernel
(``csrc/sample_2d.cu``) on the CPU.

The kernel has no CPU mode, so this file holds its launch plan to what the
kernel relies on, by the kernel's own decomposition: block u takes unit u,
(image, run of planes, tile row, tile column), the tile column fastest;
round r of warp v covers the tile's samples (v R + r) 32 + lane,
row-major, on each plane of the run; so every sample is written exactly
once. It then emulates the kernel in torch on its plan:
each unit's taps on each of its planes (the snapped coordinates, a sample
outside the source written as +0), the unit's tap bounding box over its
planes (taps outside the source included), the branch (staged where the
box fits the budget), the taps read from the flattened, zero-padded box
without a test or from the source at the kernel's element offsets, and the same f32 products and sums; and holds it to the plain
version's bits, under cameras that take both branches and with NaN and
out-of-image coordinates (and, with Inf / NaN features, where a sample
outside the source writes +0, the plain version's values elsewhere). Last, the plain version against the TPU kernel in interpret
mode at 64 channels on uniform planes and at 16 on per-pixel planes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import to_torch
from mdfnet_tpu import geometry as jgeo
from mdfnet_tpu.data.synthetic import make_plane_scene
from mdfnet_tpu.ops.pallas.warp_kernel import pallas_sample_2d_multi
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops.cuda import warp_kernel
from mdfnet_tpu_torch.ops.cuda.warp_kernel import (THREADS, sample_2d_plain,
                                                   sample_grid, sample_plan)

BF16, F32 = torch.bfloat16, torch.float32
# (S, D, H, W, source H, W, C, dtype): the DTU train stages (dense bf16,
# the fused backward in f32, C/G = 4), the DTU eval stages (one source),
# then extents that the tiles do not divide
SHAPES = [(16, 48, 64, 80, 64, 80, 32, BF16), (16, 24, 128, 160, 128, 160, 16, BF16),
          (16, 8, 256, 320, 256, 320, 8, BF16), (16, 48, 64, 80, 64, 80, 32, F32),
          (16, 24, 128, 160, 128, 160, 16, F32), (16, 8, 256, 320, 256, 320, 8, F32),
          (4, 48, 64, 80, 64, 80, 64, BF16), (4, 8, 256, 320, 256, 320, 16, BF16),
          (1, 48, 148, 200, 148, 200, 64, BF16), (1, 24, 296, 400, 296, 400, 32, BF16),
          (1, 8, 592, 800, 592, 800, 16, BF16),
          (2, 3, 13, 37, 13, 37, 8, BF16), (1, 5, 7, 70, 9, 41, 24, F32),
          (3, 1, 1, 5, 4, 4, 64, BF16), (2, 2, 33, 17, 20, 30, 128, F32)]


def _lanes(plan):
    """The kernel's sample of each (tile-local) lane slot i: (row, col),
    with row >= tile_h for a slot past the tile."""
    i = np.arange(THREADS * plan.rounds)
    return i // plan.tile_w, i % plan.tile_w


def _units(plan, d):
    """(image, first plane, planes, tile row, tile column) of each unit."""
    u = np.arange(plan.units)
    runs = -(-d // plan.run)
    tw, u = u % plan.tiles_w, u // plan.tiles_w
    th, u = u % plan.tiles_h, u // plan.tiles_h
    d0 = (u % runs) * plan.run
    return u // runs, d0, np.minimum(plan.run, d - d0), th, tw


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_every_sample_once(shape):
    s, d, h, w, hs, ws, c, dtype = shape
    plan = sample_plan(s, d, h, w, hs, ws, c, dtype, staged=True)
    esize = torch.finfo(dtype).bits // 8
    # the launch: units, lanes, rounds, shared memory, 32-bit offsets
    assert 1 <= plan.run <= 8
    assert plan.units == s * -(-d // plan.run) * plan.tiles_h * plan.tiles_w
    assert plan.tiles_h * plan.tile_h >= h > (plan.tiles_h - 1) * plan.tile_h
    assert plan.tiles_w * plan.tile_w >= w > (plan.tiles_w - 1) * plan.tile_w
    assert plan.tile_h * plan.tile_w <= THREADS * plan.rounds
    assert plan.lanes in (1, 2, 4, 8) and plan.lanes * 8 >= min(c, 64)
    assert plan.smem == plan.budget * esize + 16 * THREADS * plan.rounds
    assert plan.smem <= 227 * 1024
    assert plan.budget * esize % 16 == 0 and plan.budget > 0
    assert hs * ws * c < 2**31 and h * w * c < 2**31 and max(hs, ws) < 2**15
    # every sample of every plane once: a block a unit, the unit's planes,
    # the lanes of its tile
    img, d0, nd, th, tw = _units(plan, d)
    row, col = _lanes(plan)
    count = np.zeros(s * d * h * w, np.int64)
    for k in range(plan.run):
        on = nd > k
        gh = th[on, None] * plan.tile_h + row[None]
        gw = tw[on, None] * plan.tile_w + col[None]
        live = (row[None] < plan.tile_h) & (gh < h) & (gw < w)
        plane = (img[on] * d + d0[on] + k)[:, None]
        count += np.bincount(((plane * h + gh) * w + gw)[live],
                             minlength=count.size)
    assert np.array_equal(count, np.ones_like(count))


def test_plan_stages_a_tiles_box_and_raises_past_its_offsets():
    # a tile's box at a one-pixel halo fits its budget; the rule stages bf16
    # sources of 64 channels, and of 32 on 24 planes or fewer
    assert [warp_kernel.stage_route(c, d, dt) for c, d, dt in (
        (64, 48, BF16), (32, 24, BF16), (32, 48, BF16), (16, 24, BF16),
        (8, 8, BF16), (32, 48, F32))] == [True, True, False, False, False,
                                         False]
    # units of 8 planes in bf16, 4 in f32, 2 in f32 at 64 channels
    assert [sample_plan(4, d, 64, 80, 64, 80, c, dt).run for c, d, dt in (
        (64, 48, BF16), (16, 24, BF16), (32, 48, F32), (64, 48, F32),
        (64, 1, F32), (8, 3, F32))] == [8, 8, 4, 2, 1, 3]
    for shape in SHAPES[:11]:
        s, d, h, w, hs, ws, c, dtype = shape
        plan = sample_plan(s, d, h, w, hs, ws, c, dtype, staged=True)
        assert (plan.tile_h + 1) * (plan.tile_w + 1) * c <= plan.budget
        assert sample_plan(s, d, h, w, hs, ws, c, dtype).budget == (
            plan.budget if warp_kernel.stage_route(c, d, dtype) else 0)
        assert sample_plan(s, d, h, w, hs, ws, c, dtype,
                           staged=False).budget == 0
    with pytest.raises(ValueError):
        sample_plan(1, 1, 8, 8, 2**15, 8, 8, BF16)
    with pytest.raises(ValueError):
        sample_plan(1, 1, 8, 8, 2**14, 2**14, 8, BF16)
    with pytest.raises(ValueError):
        sample_plan(1, 1, 2**14, 2**14, 8, 8, 8, BF16)
    with pytest.raises(ValueError):
        sample_plan(1, 1, 8, 8, 8, 8, 12, BF16)
    assert sample_grid((3, 5, 7, 9)) == (5, 7, 9)
    assert sample_grid((3, 2, 5, 7, 9)) == (10, 7, 9)
    assert sample_grid((3, 11)) == (1, 1, 11)


def emulate(image, x, y, plan, counts=None):
    """The kernel on ``plan`` in torch: for each unit its samples' taps on
    each of its planes, the box of every tap of a sample inside the source
    on any of them, the branch, and each sample's 8-channel chunks from the
    flattened box (staged: zeros outside the source) or the source at the
    kernel's element offsets,
    f32 products and sums as __fmul_rn / __fadd_rn give them. ``counts``
    gets [units staged, units on the global branch]."""
    s, hs, ws, c = image.shape
    d, h, w = sample_grid(x.shape)
    xs, ys = x.reshape(s * d, h * w), y.reshape(s * d, h * w)
    out = torch.empty((s * d, h * w, c), dtype=image.dtype)
    written = torch.zeros(s * d, h * w, dtype=torch.int64)
    row, col = (torch.from_numpy(v) for v in _lanes(plan))
    src_all = image.float().reshape(s, -1)
    chans = torch.arange(c)
    for img, d0, nd, th, tw in zip(*(v.tolist() for v in _units(plan, d))):
        gh, gw = th * plan.tile_h + row, tw * plan.tile_w + col
        active = (row < plan.tile_h) & (gh < h) & (gw < w)
        off = (gh * w + gw)[active]
        planes = []
        for pl in range(img * d + d0, img * d + d0 + nd):
            cx, cy = xs[pl, off], ys[pl, off]
            # mdf::bilinear_taps
            cx = torch.where((cx > -1.0) & (cx < ws), cx,
                             torch.full_like(cx, -1.0))
            cy = torch.where((cy > -1.0) & (cy < hs), cy,
                             torch.full_like(cy, -1.0))
            x0f, y0f = torch.floor(cx), torch.floor(cy)
            wx, wy = cx - x0f, cy - y0f
            x0, y0 = x0f.long(), y0f.long()
            live = ~(((x0 == -1) & (wx == 0)) | ((y0 == -1) & (wy == 0)))
            planes.append((pl, x0, y0, wx, wy, live))
        x0s = torch.cat([p[1][p[5]] for p in planes])
        y0s = torch.cat([p[2][p[5]] for p in planes])
        if len(x0s):   # taps outside the source included
            bx0, bw = x0s.min().item(), (x0s + 1).max().item() - x0s.min().item() + 1
            by0, bh = y0s.min().item(), (y0s + 1).max().item() - y0s.min().item() + 1
        else:
            bx0 = by0 = bw = bh = 0
        staged = plan.budget > 0 and bw * bh * c <= plan.budget
        if counts is not None:
            counts[0 if staged else 1] += 1
        # the staged box: zeros where it lies outside the source
        padded = F.pad(image[img].float(), (0, 0, 1, 1, 1, 1))
        box = padded[by0 + 1:by0 + 1 + bh, bx0 + 1:bx0 + 1 + bw].reshape(-1)
        for pl, x0, y0, wx, wy, live in planes:
            vx0, vx1, vy0, vy1 = x0 >= 0, x0 + 1 < ws, y0 >= 0, y0 + 1 < hs
            if staged:   # every tap of a live sample lies in the box
                base = box
                e, pitch = ((y0 - by0) * bw + (x0 - bx0)) * c, bw * c
                vx0 = vx1 = vy0 = vy1 = torch.ones_like(live)
            else:
                base = src_all[img]
                e, pitch = (y0 * ws + x0) * c, ws * c

            def tap(at, ok, live=live, base=base):   # zeros where not ok
                vals = torch.zeros(len(at), c)
                ok = ok & live
                if ok.any():
                    idx = at[ok][:, None] + chans
                    assert bool((idx >= 0).all() & (idx < base.numel()).all())
                    vals[ok] = base[idx]
                return vals
            v00, v01 = tap(e, vy0 & vx0), tap(e + c, vy0 & vx1)
            v10, v11 = tap(e + pitch, vy1 & vx0), tap(e + pitch + c, vy1 & vx1)
            ux, uy = (1.0 - wx)[:, None], (1.0 - wy)[:, None]
            wx, wy = wx[:, None], wy[:, None]
            top = v00 * ux + v01 * wx
            bot = v10 * ux + v11 * wx
            res = top * uy + bot * wy
            res = torch.where(live[:, None], res, torch.zeros(()))
            out[pl, off] = res.to(image.dtype)
            written[pl, off] += 1
    assert bool((written == 1).all())
    return out.reshape(x.shape + (c,))


def _sweep(s, d, h, w, yaw=0.0, per_pixel=False, seed=0):
    """(x, y) (S, D, H, W) of a plane sweep of s sources of an h x w
    reference (cameras along x at an MVS focal; ``yaw`` turns source i by
    (i + 1) yaw about y, with planes from 40 to 5000)."""
    gen = torch.Generator().manual_seed(seed)
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(s + 1, 1, 1)
    e[:, 0, 3] = -torch.arange(s + 1) * 12.0
    for i in range(1, s + 1):
        cs, sn = np.cos(i * yaw), np.sin(i * yaw)
        e[i, 0, 0], e[i, 0, 2], e[i, 2, 0], e[i, 2, 2] = cs, sn, -sn, cs
    ref_proj, src_projs = geometry.projection_matrices(
        k[None, None].repeat(1, s + 1, 1, 1), e[None], 3, num_stages=4)
    near, far = (40.0, 5000.0) if yaw else (425.0, 935.0)
    hyp = torch.linspace(near, far, d).reshape(1, d, 1, 1)
    if per_pixel:
        hyp = hyp + torch.rand(1, 1, h, w, generator=gen) * 40.0
    x, y = geometry.sweep_coordinates(
        src_projs[0], ref_proj.expand(s, 4, 4),
        hyp.expand(s, d, *hyp.shape[2:]), h, w)
    x, y = geometry.reference_grid_coords(x, y, h, w)
    return x.reshape(s, d, h, w).contiguous(), y.reshape(s, d, h, w).contiguous()


def _image(s, h, w, c, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(s, h, w, c, generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("s,d,h,w,c,per_pixel", [
    (2, 3, 13, 37, 8, False), (3, 2, 21, 19, 16, True),
    (1, 4, 17, 45, 24, False), (2, 2, 40, 72, 64, True)])
def test_emulation_gives_the_plain_bits(dtype, s, d, h, w, c, per_pixel):
    x, y = _sweep(s, d, h, w, per_pixel=per_pixel)
    img = _image(s, h, w, c, dtype)
    plan = sample_plan(s, d, h, w, h, w, c, dtype, staged=True)
    counts = [0, 0]
    got = emulate(img, x, y, plan, counts)
    assert torch.equal(got, sample_2d_plain(img, x, y))
    assert counts[0] > counts[1]
    # every tile on the global branch: the same bits
    glob = emulate(img, x, y, plan._replace(budget=0), counts)
    assert torch.equal(glob, got)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("c", [16, 64])
def test_emulation_under_stress_cameras_takes_both_branches(dtype, c):
    """Sources turned by 20 degrees a view and planes from 40 to 5000: most
    samples leave the source, and the tiles near the far planes span more
    of it than the budget holds."""
    s, d, h, w = 3, 6, 40, 72
    x, y = _sweep(s, d, h, w, yaw=0.35)
    img = _image(s, h, w, c, dtype)
    plan = sample_plan(s, d, h, w, h, w, c, dtype, staged=True)
    # a budget of a tile's box at a three-pixel halo
    plan = plan._replace(budget=(plan.tile_h + 3) * (plan.tile_w + 3) * c)
    counts = [0, 0]
    got = emulate(img, x, y, plan, counts)
    assert counts[0] > 0 and counts[1] > 0
    assert torch.equal(got, sample_2d_plain(img, x, y))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_emulation_with_nan_and_outside_coordinates(dtype):
    """NaN and out-of-image coordinates, integer ones and the edges: a
    sample outside writes +0 (the plain version's bits but at NaN, where
    it gives NaN)."""
    rng = np.random.RandomState(3)
    s, d, h, w, c = 2, 3, 11, 23, 16
    x = torch.from_numpy(rng.uniform(-3, w + 2, (s, d, h, w)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-3, h + 2, (s, d, h, w)).astype(np.float32))
    x[0, 0, :2] = torch.floor(x[0, 0, :2])            # integer coordinates
    x[0, 1, 0, :4] = torch.tensor([-1.0, w - 1.0, -0.5, w - 0.5])
    y[0, 1, 0, :4] = torch.tensor([h - 1.0, -1.0, h - 0.5, -0.25])
    nan = torch.zeros_like(x, dtype=torch.bool)
    nan[1, 2, 3:5] = True
    x[nan] = float("nan")
    y[1, 0, 6, 7] = float("nan")
    nan[1, 0, 6, 7] = True
    img = _image(s, h, w, c, dtype)
    plan = sample_plan(s, d, h, w, h, w, c, dtype, staged=True)
    got = emulate(img, x, y, plan)
    ref = sample_2d_plain(img, x, y)
    assert torch.equal(got[~nan], ref[~nan])
    assert torch.equal(got[nan], torch.zeros_like(got[nan]))
    assert bool(torch.isnan(ref[nan].float()).all())


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_emulation_with_non_finite_features(dtype):
    """Inf and NaN features in the source's first row and column: every
    sample inside the source gives the plain version's values (NaN where
    it reads one, even at a zero weight); a sample outside writes +0, where
    the plain version multiplies the in-source taps by their zero weights
    and gives NaN next to a non-finite edge (warp_kernel's docstring)."""
    rng = np.random.RandomState(5)
    s, d, h, w, c = 2, 3, 11, 23, 16
    x = torch.from_numpy(rng.uniform(-3, w + 2, (s, d, h, w)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-3, h + 2, (s, d, h, w)).astype(np.float32))
    img = _image(s, h, w, c, dtype)
    img[0, 0, 3:6] = float("nan")
    img[0, 4:8, 0, :5] = float("inf")
    img[1, 0, 0] = float("-inf")
    img[1, 2:9, 0] = float("nan")
    plan = sample_plan(s, d, h, w, h, w, c, dtype, staged=True)
    got = emulate(img, x, y, plan)
    ref = sample_2d_plain(img, x, y)
    inside = ((x > -1) & (x < w) & (y > -1) & (y < h))[..., None].expand_as(ref)
    torch.testing.assert_close(got[inside], ref[inside], rtol=0, atol=0,
                               equal_nan=True)
    assert bool(torch.isnan(got[inside].float()).any())
    assert torch.equal(got[~inside], torch.zeros_like(got[~inside]))
    assert bool(torch.isnan(ref[~inside].float()).any())


def test_emulation_on_a_coordinate_grid_of_one_row():
    """(S, N) coordinates: one row of N a plane, as sample_2d takes them."""
    x, y = _sweep(2, 3, 9, 20)
    x, y = x.reshape(2, -1), y.reshape(2, -1)
    img = _image(2, 9, 20, 8, F32)
    plan = sample_plan(2, *sample_grid(x.shape), 9, 20, 8, F32)
    assert torch.equal(emulate(img, x, y, plan), sample_2d_plain(img, x, y))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, y = _sweep(2, 2, 9, 20)
    img = _image(2, 9, 20, 8, BF16)
    before = warp_kernel.LAUNCHES["sample_2d"]
    got = warp_kernel.sample_2d(img, x, y, staged=False)
    assert torch.equal(got, sample_2d_plain(img, x, y))
    assert warp_kernel.LAUNCHES["sample_2d"] == before


# The plain version against the TPU kernel in interpret mode. f32 on both
# sides, but the TPU kernel blends its taps in another order (its x weights
# applied to a row pair at once), so the two differ by f32 rounding: the
# tolerance of tests/test_torch_train_kernels.py.
ATOL = 1e-4


@pytest.mark.parametrize("c,per_pixel", [(64, False), (16, True)])
def test_plain_matches_the_tpu_kernel(c, per_pixel):
    rng = np.random.RandomState(4)
    b, d, h, w = 2, 3, 16, 40
    scene = make_plane_scene(height=h, width=w, nviews=2, plane_depth=600.0,
                             tilt=0.05)
    intr = np.repeat(scene.intrinsics[None], b, 0)
    extr = np.repeat(scene.extrinsics[None], b, 0)
    rp, sp = jgeo.projection_matrices(jnp.asarray(intr), jnp.asarray(extr), 2)
    hyp = np.linspace(520, 680, d, dtype=np.float32)[None, :, None, None]
    hyp = np.repeat(hyp, b, 0)
    if per_pixel:
        hyp = hyp + rng.rand(b, d, h, w).astype(np.float32) * 5.0
    x, y = geometry.sweep_coordinates(*to_torch(np.asarray(sp[:, 0]),
                                                np.asarray(rp), hyp), h, w)
    x, y = geometry.reference_grid_coords(x, y, h, w)
    x, y = x.reshape(b, d * h, w), y.reshape(b, d * h, w)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    got = sample_2d_plain(torch.from_numpy(feat), x, y).numpy()
    pallas, _ = pallas_sample_2d_multi(
        jnp.asarray(feat), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
