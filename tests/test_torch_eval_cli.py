"""The port's eval CLI on a synthetic DTU eval tree vs the JAX eval CLI on
the same tree and the same reference-schema .pth."""
import os

import numpy as np
import pytest
from PIL import Image

import mdfnet_tpu.cli.eval as jax_cli
from _torch_port_helpers import depth_error, jax_model_and_port, scene_args
from mdfnet_tpu.cli.eval import main as jax_eval_main
from mdfnet_tpu.config import ModelConfig
from mdfnet_tpu.data.formats import read_pfm
from mdfnet_tpu.data.synthetic import write_dtu_eval_tree
from mdfnet_tpu.utils.pth_import import save_reference_checkpoint
from mdfnet_tpu_torch.cli.eval import main as port_eval_main


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_eval_cli_matches_jax_cli(tmp_path, monkeypatch):
    data = tmp_path / "data"
    write_dtu_eval_tree(str(data / "dtu1600x1200"), scans=(9,), nviews=3,
                        height=64, width=96)
    _, variables, _ = jax_model_and_port(ModelConfig(), scene_args(64, 96, 3))
    ckpt = str(tmp_path / "model.pth")
    save_reference_checkpoint(ckpt, variables, epoch=3)

    common = ["-p", ckpt, "--root", str(data), "--scans", "9"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_stats = {}

    def jax_run_eval(*args, **kwargs):
        jax_stats.update(run_eval(*args, **kwargs))
        return jax_stats
    run_eval = jax_cli.run_eval
    monkeypatch.setattr(jax_cli, "run_eval", jax_run_eval)
    jax_eval_main(common + ["-o", jax_out])
    stats = port_eval_main(common + ["-o", port_out, "--device", "cpu"])

    # run_eval's keys: the JAX package's, and the port's first-map latency
    assert set(stats) == set(jax_stats) | {"first_map_sec"}
    assert stats["views_per_sec"] == pytest.approx(1 / stats["sec_per_view"])
    assert stats["device_views_per_sec"] == stats["views_per_sec"]
    assert stats["sec_per_view"] == stats["device_sec_per_view"]
    assert stats["n_coverage_fallbacks"] == jax_stats[
        "n_coverage_fallbacks"] == 0
    assert stats["coverage_fallback_rate"] == 0.0

    files = _tree(port_out)
    assert files == _tree(jax_out) and len(files) == 9   # 3 views x 3 files
    assert stats["n_views"] == 2 and stats["first_map_sec"] > 0
    for name in files:
        a, b = (os.path.join(port_out, name), os.path.join(jax_out, name))
        if name.endswith(".png"):
            # 8-bit visualisation of the depth: at most one level apart
            diff = np.abs(np.asarray(Image.open(a), np.int16)
                          - np.asarray(Image.open(b), np.int16))
            assert diff.max() <= 1, name
            continue
        (pa, sa), (pb, sb) = read_pfm(a), read_pfm(b)
        assert pa.shape == pb.shape == (64, 96) and sa == sb
        if "depth_est" in name:
            # the JAX CLI's CPU default is the dense warp, exact for these
            # MVS-style cameras up to f32 rounding; fitting clamps can flip
            # a pixel, hence the median far below the max bound
            err = depth_error(pa, pb)
            assert np.median(err) <= 1e-5 and err.max() <= 1e-3, name
        else:
            np.testing.assert_allclose(pa, pb, atol=1e-4, err_msg=name)
