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
from mdfnet_tpu.data import datasets as jax_datasets
from mdfnet_tpu.data import formats as jax_formats
from mdfnet_tpu.data import pipeline as jax_pipeline
from mdfnet_tpu.data import synthetic as jax_synthetic
from mdfnet_tpu.utils import pth_import as jax_pth
from mdfnet_tpu_torch import config as port_config
from mdfnet_tpu_torch.data import datasets as port_datasets
from mdfnet_tpu_torch.data import formats as port_formats
from mdfnet_tpu_torch.data import pipeline as port_pipeline
from mdfnet_tpu_torch.data import synthetic as port_synthetic
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.utils import pth_import as port_pth


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "TrainConfig", "EvalConfig",
                                  "DataConfig"])
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
