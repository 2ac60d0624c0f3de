"""The port's own copies of the JAX package's host modules (config, data
formats, datasets, batch loader, synthetic scenes, the weight export) give
what the JAX package's modules give: the same bytes on disk, the same arrays,
the same batches, the same defaults."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from mdfnet_tpu import config as jax_config
from mdfnet_tpu.benchmarks import tanks_submit as jax_submit
from mdfnet_tpu.cli import viz as jax_viz
from mdfnet_tpu.data import datasets as jax_datasets
from mdfnet_tpu.data import formats as jax_formats
from mdfnet_tpu.data import pipeline as jax_pipeline
from mdfnet_tpu.data import synthetic as jax_synthetic
from mdfnet_tpu.utils import pth_import as jax_pth
from mdfnet_tpu_torch import config as port_config
from mdfnet_tpu_torch.benchmarks import tanks_submit as port_submit
from mdfnet_tpu_torch.cli import viz as port_viz
from mdfnet_tpu_torch.data import datasets as port_datasets
from mdfnet_tpu_torch.data import formats as port_formats
from mdfnet_tpu_torch.data import pipeline as port_pipeline
from mdfnet_tpu_torch.data import synthetic as port_synthetic
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.utils import pth_import as port_pth


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "TrainConfig", "EvalConfig",
                                  "DataConfig", "MeshConfig"])
def test_config_defaults_field_by_field(name):
    assert _fields(getattr(port_config, name)) == \
        _fields(getattr(jax_config, name))


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_pfm_bytes(tmp_path, shape):
    img = np.random.RandomState(0).randn(*shape).astype(np.float32)
    a, b = str(tmp_path / "port.pfm"), str(tmp_path / "jax.pfm")
    port_formats.write_pfm(a, img)
    jax_formats.write_pfm(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        got, scale = port_formats.read_pfm(path)
        want, want_scale = jax_formats.read_pfm(path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)
        assert scale == want_scale


def test_cam_and_pair_bytes(tmp_path):
    rng = np.random.RandomState(1)
    k = rng.rand(3, 3).astype(np.float32)
    e = rng.rand(4, 4).astype(np.float32)
    for mod, tag in ((port_formats, "port"), (jax_formats, "jax")):
        mod.write_cam_file(str(tmp_path / f"{tag}_cam.txt"), k, e,
                           (425.0, 2.5, 192.0, 935.0))
        mod.write_pair_file(str(tmp_path / f"{tag}_pair.txt"),
                            [(0, [1, 2]), (1, [0, 2]), (2, [1, 0])])
    for kind in ("cam", "pair"):
        assert (tmp_path / f"port_{kind}.txt").read_bytes() == \
            (tmp_path / f"jax_{kind}.txt").read_bytes()
    got = port_formats.read_cam_file(str(tmp_path / "jax_cam.txt"))
    want = jax_formats.read_cam_file(str(tmp_path / "jax_cam.txt"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port_formats.read_pair_file(str(tmp_path / "jax_pair.txt")) == \
        jax_formats.read_pair_file(str(tmp_path / "jax_pair.txt"))


@pytest.mark.parametrize("kind", ["plane", "steps", "sphere", "ridges"])
def test_synthetic_scene_arrays(kind):
    def make(mod):
        if kind == "plane":
            return mod.make_plane_scene(height=24, width=40, nviews=3,
                                        tilt=0.05, focal=72.0)
        return mod.make_structured_scene(height=16, width=24, nviews=3,
                                         structure=kind)
    got, want = make(port_synthetic), make(jax_synthetic)
    for field in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, field.name),
                                      getattr(want, field.name),
                                      err_msg=field.name)
    b_got = port_synthetic.make_batch(got, batch=2)
    b_want = jax_synthetic.make_batch(want, batch=2)
    for k in ("imgs", "intrinsics", "extrinsics", "depth_range"):
        np.testing.assert_array_equal(b_got[k], b_want[k])
    for k in b_want["ref_depths"]:
        np.testing.assert_array_equal(b_got["ref_depths"][k],
                                      b_want["ref_depths"][k])


def _tree_bytes(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """DTU train and eval trees written by each package's writer."""
    root = tmp_path_factory.mktemp("trees")
    for mod, tag in ((port_synthetic, "port"), (jax_synthetic, "jax")):
        mod.write_dtu_train_tree(str(root / tag / "train"), scans=(1, 2),
                                 nviews=5, lightings=2, height=16, width=24)
        mod.write_dtu_eval_tree(str(root / tag / "eval"), scans=(9,),
                                nviews=4, height=16, width=24)
    return root


@pytest.mark.parametrize("split", ["train", "eval"])
def test_dtu_tree_writers_write_the_same_bytes(trees, split):
    got = _tree_bytes(trees / "port" / split)
    assert got == _tree_bytes(trees / "jax" / split) and len(got) > 5


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_items_equal(got[k], v)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("robust", [True, False])
def test_dtu_train_items(trees, robust):
    root = str(trees / "jax" / "train")
    kw = dict(scans=(1, 2), lightings=(0, 1), nviews=3,
              robust_sampling=robust)
    got = port_datasets.DTUTrainDataset(root, **kw)
    want = jax_datasets.DTUTrainDataset(root, **kw)
    assert len(got) == len(want) == 2 * 5 * 2
    for ds in (got, want):
        ds.set_epoch(3)
    for i in (0, 7, 19):
        _assert_items_equal(got[i], want[i])


def test_dtu_eval_items(trees):
    root = str(trees / "jax" / "eval")
    got = port_datasets.DTUEvalDataset(root, scans=(9,), nviews=3,
                                       crop_height=12)
    want = jax_datasets.DTUEvalDataset(root, scans=(9,), nviews=3,
                                       crop_height=12)
    assert len(got) == len(want) == 4
    for i in range(4):
        _assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_loader_batches_for_a_seed(trees, workers):
    root = str(trees / "jax" / "train")
    ds = port_datasets.DTUTrainDataset(root, scans=(1, 2), lightings=(0,),
                                       nviews=3)
    kw = dict(batch_size=3, shuffle=True, drop_last=True,
              num_workers=workers, seed=11)
    got = list(port_pipeline.BatchLoader(ds, **kw))
    want = list(jax_pipeline.BatchLoader(ds, **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _assert_items_equal(a, b)


def test_variables_to_state_dict():
    """The export of a JAX variable tree (here the JAX importer's tree of a
    port model's weights) gives the JAX export's state_dict, which loads
    strictly into the port."""
    model = build_model(seed=4, device="cpu")
    variables = jax_pth.state_dict_to_variables(model.state_dict())
    got = port_pth.variables_to_state_dict(variables)
    want = jax_pth.variables_to_state_dict(variables)
    assert set(got) == set(want) and len(got) > 250
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    other = build_model(seed=5, device="cpu")
    other.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in got.items()}, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0)


# ----------------------------------------------- fusion and Tanks host copies

from mdfnet_tpu.fusion import pairs as jax_pairs  # noqa: E402
from mdfnet_tpu.fusion import ply as jax_ply  # noqa: E402
from mdfnet_tpu.fusion import presets as jax_presets  # noqa: E402
from mdfnet_tpu.fusion import view_store as jax_view_store  # noqa: E402
from mdfnet_tpu_torch.fusion import pairs as port_pairs  # noqa: E402
from mdfnet_tpu_torch.fusion import ply as port_ply  # noqa: E402
from mdfnet_tpu_torch.fusion import presets as port_presets  # noqa: E402
from mdfnet_tpu_torch.fusion import view_store as port_view_store  # noqa: E402


@pytest.mark.parametrize("fields", ["xyz", "rgb", "normals", "all"])
def test_ply_bytes_and_round_trip(tmp_path, fields):
    rng = np.random.RandomState(2)
    xyz = rng.randn(37, 3).astype(np.float32)
    rgb = rng.randint(0, 256, (37, 3)).astype(np.uint8) \
        if fields in ("rgb", "all") else None
    nrm = rng.randn(37, 3).astype(np.float32) \
        if fields in ("normals", "all") else None
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    port_ply.write_ply(a, xyz, rgb, nrm)
    jax_ply.write_ply(b, xyz, rgb, nrm)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, got_rgb = port_ply.read_ply(a)
    want, want_rgb = jax_ply.read_ply(a)
    np.testing.assert_array_equal(got, xyz)
    np.testing.assert_array_equal(got, want)
    if rgb is None:
        assert got_rgb is None and want_rgb is None
    else:
        np.testing.assert_array_equal(got_rgb, rgb)
        np.testing.assert_array_equal(got_rgb, want_rgb)


def test_ply_ascii_read(tmp_path):
    path = tmp_path / "ascii.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n"
                    "1 2 3 10 20 30\n4.5 5 6 40 50 60\n")
    for got, want in zip(port_ply.read_ply(str(path)),
                         jax_ply.read_ply(str(path))):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_vote_presets():
    for table in ("DTU_VOTE", "TANKS_INTERMEDIATE_VOTE",
                  "TANKS_ADVANCED_VOTE"):
        assert getattr(port_presets, table) == getattr(jax_presets, table)
    for dataset, scene in (("dtu", "scan9"), ("intermediate", "Family"),
                           ("intermediate", "Unknown"),
                           ("advanced", "Temple")):
        assert port_presets.vote_preset(dataset, scene) == \
            jax_presets.vote_preset(dataset, scene)


def test_find_pair_file(tmp_path):
    (tmp_path / "scan1").mkdir()
    (tmp_path / "scene").mkdir()
    (tmp_path / "pair.txt").write_text("0\n")
    (tmp_path / "scene" / "pair.txt").write_text("0\n")
    for scan in ("scan1", "scene", "scan1/"):
        d = str(tmp_path / scan)
        assert port_pairs._find_pair_file(d) == jax_pairs._find_pair_file(d)
    with pytest.raises(FileNotFoundError):
        port_pairs._find_pair_file(str(tmp_path / "scan1" / "missing"))


def test_view_store_lru_and_spill(tmp_path):
    """tests/test_fusion_memory.py's LRU and exact spill, on the port's
    copy."""
    loads = []

    def load(vid):
        loads.append(vid)
        return {"depth": np.full((4, 4), float(vid), np.float32)}

    with port_view_store.ViewStore(load, maxsize=2) as store:
        assert store.get(0)["depth"][0, 0] == 0
        assert store.get(1)["depth"][0, 0] == 1
        store.update(0, depth=np.full((4, 4), 100.0, np.float32))
        assert store.get(2)["depth"][0, 0] == 2     # evicts dirty 0 -> spill
        assert store.get(3)["depth"][0, 0] == 3     # evicts clean 1
        assert store.get(0)["depth"][0, 0] == 100.0
        assert store.get(1)["depth"][0, 0] == 1
        assert loads.count(0) == 1
        assert loads.count(1) >= 2
        assert store.peak_resident <= 2
        spill = store._spill
    assert not os.path.exists(spill)


def test_pad_sources():
    d = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    k = np.stack([np.eye(3), 2 * np.eye(3)]).astype(np.float32)
    (dp, kp), valid = port_view_store.pad_sources([d, k], 5)
    assert dp.shape == (5, 3, 4) and kp.shape == (5, 3, 3)
    assert valid.tolist() == [True, True, False, False, False]
    np.testing.assert_array_equal(dp[2:], np.repeat(d[:1], 3, axis=0))
    (d2,), valid2 = port_view_store.pad_sources([d], 2)
    assert d2 is not dp and valid2.all()
    for max_s in (2, 5):
        got, got_valid = port_view_store.pad_sources([d, k], max_s)
        want, want_valid = jax_view_store.pad_sources([d, k], max_s)
        np.testing.assert_array_equal(got_valid, want_valid)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_mask_png_bytes(tmp_path):
    mask = np.random.RandomState(4).rand(9, 13) > 0.5
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    port_formats.write_mask_png(a, mask)
    jax_formats.write_mask_png(b, mask)
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(AssertionError):
        port_formats.write_mask_png(a, mask.astype(np.uint8))


def test_tanks_eval_items(tmp_path):
    root = str(tmp_path / "intermediate")
    port_synthetic.write_tanks_eval_tree(root, scenes=("Family", "Horse"),
                                         nviews=6, height=20, width=28)
    kw = dict(scenes=("Family", "Horse"), nviews=4, crop_height=16)
    got = port_datasets.TanksEvalDataset(root, **kw)
    want = jax_datasets.TanksEvalDataset(root, **kw)
    assert len(got) == len(want) == 12
    for i in (0, 5, 11):
        _assert_items_equal(got[i], want[i])
    item = got[5]
    assert item["imgs"].shape == (4, 16, 28, 3)
    assert item["filename"] == "Family/{}/00000005{}"
    np.testing.assert_array_equal(item["depth_range"], [425.0, 935.0])


# ------------------------------------------------ the tool CLIs' copies

def _write_cams(root, n=3):
    root.mkdir()
    rng = np.random.RandomState(4)
    for i in range(n):
        port_formats.write_cam_file(
            str(root / f"{i:08d}_cam.txt"), rng.rand(3, 3).astype(np.float32),
            rng.rand(4, 4).astype(np.float32), (425.0, 2.5, 192.0, 935.0))
    (root / "pair.txt").write_text("not a cam")


def test_viz_rescale_cams_writes_the_jax_bytes(tmp_path):
    _write_cams(tmp_path / "cams")
    port_viz.main(["rescale-cams", str(tmp_path / "cams"),
                   str(tmp_path / "port"), "--factor", "4"])
    jax_viz.main(["rescale-cams", str(tmp_path / "cams"),
                  str(tmp_path / "jax"), "--factor", "4"])
    got = _tree_bytes(tmp_path / "port")
    assert got == _tree_bytes(tmp_path / "jax") and len(got) == 3


@pytest.mark.parametrize("command", ["catpfm", "lossplot"])
def test_viz_plots_draw_what_jax_draws(tmp_path, command):
    """The same PNG as the JAX CLI's, decoded (matplotlib, imported by the
    command alone)."""
    pytest.importorskip("matplotlib")
    if command == "catpfm":
        src = tmp_path / "depth.pfm"
        port_formats.write_pfm(str(src), np.random.RandomState(5).rand(
            12, 16).astype(np.float32))
        extra = ["--clip-min", "0.2", "--clip-max", "0.8"]
    else:
        src = tmp_path / "epoch_loss.txt"
        src.write_text("3.5\n2.25\n1.75\n")
        extra = []
    for mod, tag in ((port_viz, "port"), (jax_viz, "jax")):
        mod.main([command, str(src), str(tmp_path / f"{tag}.png"), *extra])
    got = port_formats.read_image(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(
        got, port_formats.read_image(str(tmp_path / "jax.png")))
    assert got.shape[0] > 100


@pytest.fixture()
def packaged(tmp_path):
    ply_dir, log_dir = tmp_path / "plys", tmp_path / "logs"
    ply_dir.mkdir()
    log_dir.mkdir()
    for scene in ("Family", "Horse"):
        (ply_dir / f"{scene}.ply").write_bytes(b"ply\n" + scene.encode())
        (log_dir / f"{scene}.log").write_text(f"trajectory {scene}")
    out = {}
    for mod, tag in ((port_submit, "port"), (jax_submit, "jax")):
        sums = mod.package_submission(str(ply_dir), str(log_dir),
                                      str(tmp_path / tag), log_fn=None)
        out[tag] = (str(tmp_path / tag), sums)
    return out


def test_tanks_package_matches_jax(packaged):
    """The same pairs and MD5 manifest as the JAX package's, scenes without
    a cloud skipped; the scene lists are the same."""
    (port_out, port_sums), (jax_out, jax_sums) = packaged["port"], \
        packaged["jax"]
    assert port_sums == jax_sums and len(port_sums) == 4
    assert _tree_bytes(port_out) == _tree_bytes(jax_out)
    assert port_submit.INTERMEDIATE == jax_submit.INTERMEDIATE
    assert port_submit.ADVANCED == jax_submit.ADVANCED


def test_tanks_package_needs_the_log(tmp_path):
    (tmp_path / "Family.ply").write_bytes(b"ply")
    with pytest.raises(FileNotFoundError):
        port_submit.package_submission(str(tmp_path), str(tmp_path / "none"),
                                       str(tmp_path / "out"),
                                       scenes=("Family",), log_fn=None)


def test_tanks_upload_posts_presigned_policies(packaged, tmp_path,
                                               monkeypatch):
    """Twin of tests/test_tanks_submit.py's upload test, mocked transport."""
    out, _ = packaged["port"]
    cred = tmp_path / "cred.txt"
    cred.write_text("POLICYA###SIGA###Family.ply\n"
                    "POLICYB###SIGB###Family.log\n"
                    "###results/42/###svc@t2.iam###2099-01-01\n")
    posts = []

    class FakeResponse:
        status_code = 204

    class FakeSession:
        def post(self, url, data=None, files=None, headers=None):
            posts.append((url, dict(data)))
            return FakeResponse()

    requests = pytest.importorskip("requests")
    monkeypatch.setattr(requests, "Session", FakeSession)
    port_submit.upload_submission(out, str(cred), scenes=("Family",),
                                  log_fn=None)
    assert len(posts) == 2
    url, policy = posts[0]
    assert url == "http://t2-website-userdata.storage.googleapis.com"
    assert policy["key"] == "results/42/Family.ply"
    assert policy["policy"] == "POLICYA" and policy["signature"] == "SIGA"
    assert policy["GoogleAccessId"] == "svc@t2.iam"
    assert posts[1][1]["key"] == "results/42/Family.log"
    assert posts[1][1]["policy"] == "POLICYB"
