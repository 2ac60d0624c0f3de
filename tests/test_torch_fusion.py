"""The port's fusion backends (``mdfnet_tpu_torch/fusion``) against the JAX
package's on the CPU: the dynamic filter, the consistency vote, the pcd
fusion's passes and its native cores, and the fuse CLI end to end.

Scenes come from a numpy seed (``_fusion_scenes.fusion_scene``): 32x48
pixels, a ref view and 4 sources, cameras turned about random axes, noisy
depth with holes. Masks and counts must be equal but at ties (a compared
quantity within 1e-5 relative of its threshold), and may differ on at most
1e-4 of the entries; each comparison prints how many differ and how many
lie within the tie distance. Continuous outputs must lie within 1e-5 of
their scale. ``src_valid``: the padded cases pass 3 sources padded to 4 as
the scan loops pad them.
"""
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fusion_scenes import (check_ties, close, fusion_scene, near,
                            near_integer)
from mdfnet_tpu import geometry as jax_geometry
from mdfnet_tpu.cli.fuse import main as jax_fuse_main
from mdfnet_tpu.data.formats import write_pfm
from mdfnet_tpu.data.synthetic import write_dtu_eval_tree
from mdfnet_tpu.fusion import consistency_vote as jax_vote
from mdfnet_tpu.fusion import dynamic_filter as jax_filter
from mdfnet_tpu.fusion import native as jax_native
from mdfnet_tpu.fusion import pcd_fusion as jax_pcd
from mdfnet_tpu.fusion.ply import read_ply
from mdfnet_tpu.ops.sample import bilinear_sample_2d as jax_sample
from mdfnet_tpu_torch.cli.fuse import main as port_fuse_main
from mdfnet_tpu_torch.fusion import consistency_vote as port_vote
from mdfnet_tpu_torch.fusion import dynamic_filter as port_filter
from mdfnet_tpu_torch.fusion import native as port_native
from mdfnet_tpu_torch.fusion import pcd_fusion as port_pcd
from mdfnet_tpu_torch.fusion.view_store import pad_sources

torch.set_num_threads(2)
H, W = 32, 48
PADDED = pytest.mark.parametrize("padded", [False, True],
                                 ids=["unpadded", "padded"])


def _inputs(seed: int, padded: bool):
    """(ref (depth, K, E), sources (depths, Ks, Es), src_valid or None)."""
    d, k, e = fusion_scene(seed, nviews=5, h=H, w=W)
    if padded:
        src, valid = pad_sources([d[1:4], k[1:4], e[1:4]], 4)
        return (d[0], k[0], e[0]), tuple(src), valid
    return (d[0], k[0], e[0]), (d[1:], k[1:], e[1:]), None


def _jax(ref, src, valid):
    return [jnp.asarray(a) for a in (*ref, *src)] + [
        None if valid is None else jnp.asarray(valid)]


def _port(ref, src, valid):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (*ref, *src)] \
        + [None if valid is None else torch.from_numpy(valid)]


def _np(*xs):
    return [np.array(x) for x in xs]


def _valid(valid, s):
    return np.ones(s, bool) if valid is None else valid


# ------------------------------------------------------------ dynamic filter

def _filter_ties(ref, src, valid):
    """Pixels where a source's reprojection distance or relative depth error
    lies within the tie distance of a rung of the ladder."""
    dre, xre, yre = _np(*jax.vmap(jax_filter.reproject_depth,
                                  in_axes=(None,) * 3 + (0,) * 3)(
        *map(jnp.asarray, (*ref, *src))))
    yy, xx = np.mgrid[0:H, 0:W]
    dist = np.hypot(xre - xx, yre - yy)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(dre.astype(np.float64) - ref[0]) / ref[0]
    steps = np.arange(2, 11, dtype=np.float64)
    tie = near(dist, steps / 4.0) | near(rel, steps / 1300.0)
    return (tie & _valid(valid, len(src[0]))[:, None, None]).any(0)


@PADDED
@pytest.mark.parametrize("seed", [0, 1])
def test_geometric_consistency(seed, padded):
    ref, src, valid = _inputs(seed, padded)
    want = _np(*jax_filter.geometric_consistency(*_jax(ref, src, valid)))
    got = [t.numpy() for t in port_filter.geometric_consistency(
        *_port(ref, src, valid))]
    tie = _filter_ties(ref, src, valid)
    assert got[0].dtype == got[1].dtype == np.int32
    assert 0 < want[0].sum() < want[0].size * len(src[0])
    check_ties("rung counts", got[0], want[0], tie)
    check_ties("strict count", got[1], want[1], tie)
    close("depth sum", got[2], want[2], skip=tie)


def test_reproject_depth():
    ref, src, _ = _inputs(2, False)
    want = _np(*jax_filter.reproject_depth(*ref, *(a[0] for a in src)))
    got = port_filter.reproject_depth(*(torch.from_numpy(a) for a in (
        *ref, *(a[0] for a in src))))
    for name, g, w in zip(("depth", "x", "y"), got, want):
        close(f"reprojected {name}", g.numpy(), w)


@PADDED
def test_fuse_view(padded):
    ref, src, valid = _inputs(3, padded)
    conf = np.random.RandomState(3).rand(H, W).astype(np.float32)
    kw = dict(photo_thresh=0.3, nconditions=2, src_valid=valid)
    want = jax_filter.fuse_view(ref[0], conf, *ref[1:], *src, **kw)
    got = port_filter.fuse_view(ref[0], conf, *ref[1:], *src, device="cpu",
                                **kw)
    tie = _filter_ties(ref, src, valid)
    for name, g, w in zip(("geo", "photo", "final"), got[1:], want[1:]):
        assert g.dtype == w.dtype == np.bool_
        check_ties(f"{name} mask", g, w, tie)
    assert want[3].any() and not want[3].all()
    assert got[0].dtype == want[0].dtype
    close("averaged depth", got[0], want[0], skip=tie)


# ---------------------------------------------------------- consistency vote

def _vote_ties(ref, src, valid, disp_thresh=0.25):
    """(accept ties, point ties) per ref pixel: the disparity difference
    within the tie distance of ``disp_thresh`` or a projection on the image
    border; a truncated source pixel on an integer."""
    depth, k, e = ref
    xw = jax_geometry.unproject(*(jnp.asarray(a)[None] for a in ref))
    centre = lambda m: -m[:3, :3].astype(np.float64).T @ m[:3, 3]
    tie_acc = np.zeros(H * W, bool)
    tie_pt = np.zeros(H * W, bool)
    for s, ok in enumerate(_valid(valid, len(src[0]))):
        if not ok:
            continue
        xs, ys, dx = _np(*jax_geometry.project(
            xw, jnp.asarray(src[1][s])[None], jnp.asarray(src[2][s])[None]))
        ds = np.asarray(jax_sample(jnp.asarray(src[0][s])[None, ..., None],
                                   xs, ys))[0, :, 0]
        xs, ys, dx = xs[0], ys[0], dx[0]
        fb = k[0, 0] * np.linalg.norm(centre(e) - centre(src[2][s]))
        with np.errstate(divide="ignore", invalid="ignore"):
            diff = np.abs(fb / dx - fb / ds)
        border = (np.abs(xs) <= 1e-5 * W) | (np.abs(xs - W) <= 1e-5 * W) | \
            (np.abs(ys) <= 1e-5 * H) | (np.abs(ys - H) <= 1e-5 * H)
        tie_acc |= near(diff, [disp_thresh]) | border
        tie_pt |= near_integer(xs) | near_integer(ys)
    return tie_acc, tie_pt


@PADDED
@pytest.mark.parametrize("seed", [0, 4])
def test_consistency_vote(seed, padded):
    ref, src, valid = _inputs(seed, padded)
    pts_w, acc_w = _np(*jax_vote.consistency_vote(*_jax(ref, src, valid)))
    pts_g, acc_g = (t.numpy() for t in port_vote.consistency_vote(
        *_port(ref, src, valid)))
    tie_acc, tie_pt = _vote_ties(ref, src, valid)
    assert acc_w.any() and not acc_w.all()
    check_ties("accept", acc_g, acc_w, tie_acc)
    both = acc_g & acc_w
    close("voted points", pts_g[both], pts_w[both], skip=tie_pt[both, None])


# ------------------------------------------------------------------- pcd

def _cells_tie(x, y):
    """A nearest-cell lookup (round(x - 0.5)) that may go either way, or
    sit on the image border."""
    return near_integer(x) | near_integer(y)


def _reproject_ties(ref, src, valid):
    """Per (source, pixel): the nearest source cell of the ref pixel's
    projection is a tie."""
    depth, k, e = map(jnp.asarray, ref)
    world = jax_pcd._img2world(jax_pcd._centers(H, W), depth.reshape(-1),
                               k, e)
    ties = []
    for s in range(len(src[0])):
        xs, ys, _ = _np(*jax_pcd._world2img(world, jnp.asarray(src[1][s]),
                                            jnp.asarray(src[2][s])))
        ties.append(_cells_tie(xs, ys).reshape(H, W))
    return np.stack(ties) & _valid(valid, len(src[0]))[:, None, None]


@PADDED
@pytest.mark.parametrize("seed", [0, 5])
def test_reproject_all_and_visibility_masks(seed, padded):
    ref, src, valid = _inputs(seed, padded)
    want = _np(*jax_pcd.reproject_all(*_jax(ref, src, valid)))
    got = [t.numpy() for t in port_pcd.reproject_all(*_port(ref, src, valid))]
    tie_cell = _reproject_ties(ref, src, valid)
    check_ties("in range", got[3], want[3], tie_cell)
    for name, g, w in zip("xyd", got[:3], want[:3]):
        close(f"reprojected {name}", g, w, skip=tie_cell)

    masks_w, mask_w = _np(*jax_pcd.visibility_masks(
        jnp.asarray(ref[0]), *map(jnp.asarray, want)))
    masks_g, mask_g = (t.numpy() for t in port_pcd.visibility_masks(
        torch.from_numpy(ref[0]), *map(torch.from_numpy, want)))
    xr, yr, dr = (a.astype(np.float64) for a in want[:3])
    yy, xx = np.mgrid[0:H, 0:W] + 0.5
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(ref[0] - dr) / np.maximum(ref[0], dr)
    tie = near(np.hypot(xr - xx, yr - yy), [1.0]) | near(rel, [0.01])
    assert mask_w.any() and not mask_w.all()
    check_ties("visibility masks", masks_g, masks_w, tie)
    check_ties("visibility vote", mask_g, mask_w, tie.any(0))

    avg_w = np.asarray(jax_pcd.averaged_depth(
        jnp.asarray(ref[0]), jnp.asarray(want[2]), jnp.asarray(masks_w)))
    avg_g = port_pcd.averaged_depth(
        torch.from_numpy(ref[0]), torch.from_numpy(want[2]),
        torch.from_numpy(masks_w)).numpy()
    close("averaged depth", avg_g, avg_w)


def _violation_ties(ref, src, valid, xy, d):
    """Per candidate: for some source, its nearest cell is a tie or its
    depth there lies within the tie distance of the source's depth (a
    source candidate's check against its own view is such a tie by
    construction)."""
    k, e = jnp.asarray(ref[1]), jnp.asarray(ref[2])
    pix = jnp.stack([xy[:, 0], xy[:, 1], jnp.ones(len(d))])
    world = jax_pcd._img2world(pix, jnp.asarray(d), k, e)
    tie = np.zeros(len(d), bool)
    for s, ok in enumerate(_valid(valid, len(src[0]))):
        if not ok:
            continue
        xs, ys, dz = jax_pcd._world2img(world, jnp.asarray(src[1][s]),
                                        jnp.asarray(src[2][s]))
        ds, _ = jax_pcd._nearest_sample(jnp.asarray(src[0][s]), xs, ys)
        xs, ys, dz, ds = _np(xs, ys, dz, ds)
        with np.errstate(invalid="ignore"):
            tie |= _cells_tie(xs, ys) | (np.abs(ds - dz.astype(np.float64))
                                         <= 1e-5 * np.abs(dz))
    return tie


@PADDED
@pytest.mark.parametrize("seed", [0, 6])
def test_candidates_and_violations(seed, padded):
    ref, src, valid = _inputs(seed, padded)
    xy_w, d_w, vio_w, ok_w = _np(*jax_pcd._candidates_and_violations(
        *_jax(ref, src, valid)))
    xy_g, d_g, vio_g, ok_g = (t.numpy() for t in
                              port_pcd._candidates_and_violations(
                                  *_port(ref, src, valid)))
    assert len(d_w) == (1 + len(src[0])) * H * W and vio_g.dtype == np.int32
    np.testing.assert_array_equal(ok_g, ok_w)
    close("candidate xy", xy_g[ok_w], xy_w[ok_w])
    close("candidate depth", d_g[ok_w], d_w[ok_w])
    tie = _violation_ties(ref, src, valid, xy_w, d_w)
    assert 0 < vio_w[ok_w].sum()
    check_ties("violations", vio_g[ok_w], vio_w[ok_w], tie[ok_w])


@PADDED
def test_zbuffer_fusion(padded):
    ref, src, valid = _inputs(7, padded)
    want = jax_pcd.zbuffer_fusion(*ref, *src, src_valid=valid)
    got = port_pcd.zbuffer_fusion(*ref, *src, src_valid=valid, device="cpu")
    xy, d, _, ok = _np(*jax_pcd._candidates_and_violations(
        *_jax(ref, src, valid)))
    tie = _violation_ties(ref, src, valid, xy, d) & ok
    tie_px = np.zeros((H, W), bool)
    for dx in (-1, 0):   # a cell on a tie may be either neighbour
        cx = np.clip(np.round(xy[tie, 0]).astype(int) + dx, 0, W - 1)
        cy = np.clip(np.round(xy[tie, 1]).astype(int) + dx, 0, H - 1)
        tie_px[cy, cx] = True
    assert (want > 0).sum() > H * W // 2
    check_ties("elected depth", got, want, tie_px)


def test_normals_and_voxel_downsample():
    d, k, e = fusion_scene(8, nviews=1, h=H, w=W)
    want = jax_pcd._normals_from_depth(d[0], k[0], e[0])
    got = port_pcd._normals_from_depth(d[0], k[0], e[0])
    close("normals", got, want)
    rng = np.random.RandomState(8)
    xyz = (rng.rand(500, 3) * 10).astype(np.float32)
    rgb = rng.randint(0, 255, (500, 3)).astype(np.uint8)
    for a, b in zip(port_pcd.voxel_downsample(xyz, rgb, want[:500], 2.0),
                    jax_pcd.voxel_downsample(xyz, rgb, want[:500], 2.0)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- native cores

def _candidates(seed):
    rng = np.random.RandomState(seed)
    m, h, w = 4000, 20, 30
    xy = np.stack([rng.rand(m) * (w + 4) - 2, rng.rand(m) * (h + 4) - 2], 1)
    xy[:200] = np.round(xy[:200])          # cells on a half (x - 0.5 = k + .5)
    depth = (rng.rand(m) * 50 + 100).astype(np.float32)
    depth[rng.rand(m) < 0.1] = 0.0
    depth[300:400] = depth[200:300]        # equal depths in one cell
    xy[300:400] = xy[200:300]
    vio = rng.randint(0, 6, m).astype(np.int32)
    valid = rng.rand(h, w) > 0.1
    return depth, xy.astype(np.float32), vio, valid


def _segment_depth(seed):
    rng = np.random.RandomState(seed)
    d = np.where(rng.rand(24, 36) < 0.5, 100.0, 150.0)
    d = (d * (1 + 2e-4 * rng.randn(24, 36))).astype(np.float32)
    d[rng.rand(24, 36) < 0.3] = 0.0
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_native_library_vs_numpy_and_jax_library(seed):
    assert jax_native._load() is not None, "the JAX package's library"
    args = _candidates(seed)
    got = port_native.zbuffer_elect(*args)
    np.testing.assert_array_equal(got, port_native.zbuffer_elect_numpy(*args))
    np.testing.assert_array_equal(got, jax_native.zbuffer_elect(*args))
    assert (got > 0).sum() > 100
    depth = _segment_depth(seed)
    for window, size in ((1, 3), (4, 10)):
        got = port_native.segment_filter(depth, window, 1e-3, size)
        np.testing.assert_array_equal(
            got, port_native.segment_filter_numpy(depth, window, 1e-3, size))
        np.testing.assert_array_equal(
            got, jax_native.segment_filter(depth, window, 1e-3, size))
        assert got.any() and not got.all()
    assert port_native.library_path().exists()
    assert port_native.library_path().parent.name == "native"
    with pytest.raises(ValueError):
        port_native.zbuffer_elect(args[0], args[1][:-1], *args[2:])


def test_native_build_in_parallel_and_failure_raises(tmp_path, monkeypatch):
    """Processes that build at once each get the whole library (a temporary
    name, then os.replace); a source that does not compile raises."""
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "native")
    paths, errors = [], []

    def build():
        try:
            paths.append(port_native.build())
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    assert not errors and len(set(paths)) == 1
    assert os.listdir(tmp_path / "native") == [paths[0].name]

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "SOURCE", broken)
    port_native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            port_native.zbuffer_elect(*_candidates(0))
        assert os.listdir(tmp_path / "native") == [paths[0].name]
    finally:
        port_native.load_library.cache_clear()


# ----------------------------------------------------------------- fuse CLI

NV, CLI_H, CLI_W = 11, 24, 30


@pytest.fixture(scope="module")
def gt_outputs(tmp_path_factory):
    """An 11-view synthetic DTU eval tree and its GT depths with unit
    confidence in the eval CLI's output schema."""
    root = tmp_path_factory.mktemp("fuse")
    scene = write_dtu_eval_tree(str(root / "dtu1600x1200"), scans=(9,),
                                nviews=NV, height=CLI_H, width=CLI_W,
                                plane_depth=600.0, tilt=0.05, baseline=0.8)
    out = root / "outputs"
    for v in range(NV):
        for sub, arr in (("depth_est", scene.depths[v]),
                         ("confidence", np.ones_like(scene.depths[v]))):
            os.makedirs(out / "scan9" / sub, exist_ok=True)
            write_pfm(str(out / "scan9" / sub / f"{v:08d}.pfm"), arr)
    return root


@pytest.mark.parametrize("method", ["filter", "vote", "pcd"])
def test_fuse_cli_matches_jax_cli(gt_outputs, tmp_path, monkeypatch,
                                  method):
    common = ["-m", method, "-d", "dtu", "--root", str(gt_outputs),
              "--scans", "9", "-e", str(gt_outputs / "outputs")]
    jax_fuse_main(common + ["-o", str(tmp_path / "jax")])
    spill = tmp_path / "tmp"        # the ViewStore's spill directory goes
    spill.mkdir()                   # here, and is removed when it closes
    monkeypatch.setattr(tempfile, "tempdir", str(spill))
    port_fuse_main(common + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert not os.listdir(spill)
    want, rgb_w = read_ply(str(tmp_path / "jax" / "ours009_l3.ply"))
    got, rgb_g = read_ply(str(tmp_path / "port" / "ours009_l3.ply"))
    print(f"{method}: {len(got)} points, JAX {len(want)}")
    assert len(want) > NV * CLI_H * CLI_W // 4
    assert len(got) == len(want)
    close(f"{method} cloud", got, want)
    np.testing.assert_array_equal(rgb_g, rgb_w)
    assert (open(tmp_path / "port" / "ours009_l3.ply", "rb").readline()
            == b"ply\n")


def test_fuse_cli_without_a_card_fails(gt_outputs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        port_fuse_main(["-m", "filter", "--root", str(gt_outputs),
                        "--scans", "9", "-e", str(gt_outputs / "outputs"),
                        "-o", str(tmp_path / "plys")])
    assert exit_info.value.code != 0
    assert not (tmp_path / "plys").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pcd.zbuffer_fusion(*_inputs(0, False)[0], *_inputs(0, False)[1])
