"""The port's DTU metric (``mdfnet_tpu_torch/benchmarks/dtu_metric.py`` and
``cli/dtu_eval.py``) against the JAX package's: the same numbers, exactly,
on the same clouds and seeds. Host code in both packages (numpy, a scipy
KD-tree)."""
import json
import os

import numpy as np
import pytest
from scipy.io import savemat

from mdfnet_tpu.benchmarks import dtu_metric as jax_metric
from mdfnet_tpu.cli.dtu_eval import main as jax_metric_main
from mdfnet_tpu_torch.benchmarks import dtu_metric as port_metric
from mdfnet_tpu_torch.cli.dtu_eval import main as port_metric_main
from mdfnet_tpu_torch.cli.fuse import main as port_fuse_main
from mdfnet_tpu_torch.data import write_dtu_eval_tree, write_pfm
from mdfnet_tpu_torch.fusion.ply import write_ply


def _cloud(seed, n=3000):
    rng = np.random.RandomState(seed)
    base = rng.rand(n // 10, 3) * 20
    return (base[None] + rng.randn(10, 1, 3) * 0.3).reshape(-1, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_points_and_neighbour_pairs(seed):
    pts = _cloud(seed)
    for dst in (0.2, 0.5):
        got = port_metric._neighbor_pairs(pts, dst)
        want = jax_metric._neighbor_pairs(pts, dst)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(got[0]) > 0
        np.testing.assert_array_equal(
            port_metric.reduce_points(pts, dst, seed),
            jax_metric.reduce_points(pts, dst, seed))
    assert len(port_metric.reduce_points(pts[:0], 0.2, seed)) == 0


def test_nn_distances_and_mask_lookup():
    rng = np.random.RandomState(3)
    q, t = rng.rand(400, 3) * 30, rng.rand(300, 3) * 30
    for max_dist in (60.0, 2.0):
        np.testing.assert_array_equal(
            port_metric.nn_distances(q, t, max_dist),
            jax_metric.nn_distances(q, t, max_dist))
    np.testing.assert_array_equal(port_metric.nn_distances(q, t[:0]),
                                  jax_metric.nn_distances(q, t[:0]))
    mask = rng.rand(8, 9, 10) > 0.5
    bb = np.array([[0.0, 0.0, 0.0], [28.0, 32.0, 36.0]])
    np.testing.assert_array_equal(
        port_metric._mask_lookup(q, mask, bb, 4.0),
        jax_metric._mask_lookup(q, mask, bb, 4.0))


@pytest.mark.parametrize("masked", [False, True])
def test_evaluate_scan(masked):
    rng = np.random.RandomState(4)
    stl = _cloud(5, 2000)
    data = stl[rng.rand(len(stl)) < 0.7] + rng.randn(1, 3) * 0.1
    data = np.concatenate([data, rng.rand(50, 3) * 100])   # outliers
    kw = {}
    if masked:
        kw = dict(obs_mask=rng.rand(12, 12, 12) > 0.2,
                  bb=np.array([[-2.0] * 3, [22.0] * 3]), res=2.0,
                  plane=np.array([0.0, 0.0, 1.0, -1.0]))
    got = port_metric.evaluate_scan(data, stl, seed=3, **kw)
    want = jax_metric.evaluate_scan(data, stl, seed=3, **kw)
    assert got == want and got["acc_mean"] < 20.0


def _sample_set(path, stl):
    """A synthetic DTU SampleSet for scan 9 (stl ply, ObsMask and Plane
    .mat), laid out as the official one."""
    os.makedirs(os.path.join(path, "Points", "stl"), exist_ok=True)
    os.makedirs(os.path.join(path, "ObsMask"), exist_ok=True)
    write_ply(os.path.join(path, "Points", "stl", "stl009_total.ply"),
              stl.astype(np.float32))
    lo, hi, res = stl.min(0) - 5.0, stl.max(0) + 5.0, 2.0
    shape = tuple(int(np.ceil((hi[i] - lo[i]) / res)) + 2 for i in range(3))
    mask = np.zeros(shape, np.uint8)
    q = np.round((stl - lo) / res).astype(int) + 1
    mask[q[:, 0], q[:, 1], q[:, 2]] = 1
    savemat(os.path.join(path, "ObsMask", "ObsMask9_10.mat"),
            {"ObsMask": mask, "BB": np.stack([lo, hi]),
             "Res": np.array([[res]])})
    savemat(os.path.join(path, "ObsMask", "Plane9.mat"),
            {"P": np.array([0.0, 0.0, 1.0, -(stl[:, 2].min() - 5.0)])
             .reshape(4, 1)})


def test_dtu_eval_cli_on_a_fused_cloud(tmp_path, capsys):
    """A cloud fused by the port's fuse CLI (vote, on the CPU) from GT
    depths, scored by both metric CLIs against a SampleSet made from the GT
    surface: the same JSON, and Acc / Comp within the pixel footprint."""
    root = tmp_path / "data"
    scene = write_dtu_eval_tree(str(root / "dtu1600x1200"), scans=(9,),
                                nviews=5, height=32, width=48,
                                plane_depth=600.0, tilt=0.05, baseline=2.0)
    out = tmp_path / "outputs" / "scan9"
    for v in range(5):
        for sub, arr in (("depth_est", scene.depths[v]),
                         ("confidence", np.ones_like(scene.depths[v]))):
            os.makedirs(out / sub, exist_ok=True)
            write_pfm(str(out / sub / f"{v:08d}.pfm"), arr)
    plys = tmp_path / "plys"
    port_fuse_main(["-m", "vote", "--root", str(root), "--scans", "9",
                    "-e", str(tmp_path / "outputs"), "-o", str(plys),
                    "--device", "cpu"])
    # the GT surface: view 0's depth back-projected (identity rotation)
    h, w = scene.depths[0].shape
    k, e = scene.intrinsics[0].astype(np.float64), scene.extrinsics[0]
    ys, xs = np.mgrid[0:h, 0:w]
    cam = np.linalg.inv(k) @ np.stack([xs.ravel(), ys.ravel(),
                                       np.ones(h * w)])
    stl = (cam * scene.depths[0].ravel()).T - e[:3, 3]
    _sample_set(str(tmp_path / "SampleSet"), stl)
    args = ["--ply_dir", str(plys), "--sample_set",
            str(tmp_path / "SampleSet"), "--scans", "9"]
    capsys.readouterr()
    port_metric_main(args)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_metric_main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    print(got)
    assert got == want
    # depth 600 / focal 320: ~1.9 world units a pixel
    assert got["acc"] < 1.5 and got["comp"] < 1.5
