"""The port's eval CLI on the Tanks & Temples branch (``-d tanks``, 11
views) vs the JAX eval CLI's ``-d tanks --exact`` (the f32 gather path) on
the same synthetic Tanks tree and the same reference-schema .pth."""
import os

import numpy as np
import pytest
import torch

from _torch_port_helpers import depth_error
from mdfnet_tpu.cli.eval import main as jax_eval_main
from mdfnet_tpu.data.formats import read_pfm
from mdfnet_tpu_torch.cli.eval import main as port_eval_main
from mdfnet_tpu_torch.data import (read_pair_file, write_pair_file,
                                   write_tanks_eval_tree)
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.utils.weights import save_checkpoint

H, W, NV = 32, 64, 11


@pytest.fixture(scope="module")
def tanks(tmp_path_factory):
    """A synthetic 11-view Tanks scene (two of its views as references, each
    with 10 sources) and a .pth of seeded weights, the BatchNorm statistics
    drawn from a numpy seed (so that the folded epilogues are exercised)."""
    root = tmp_path_factory.mktemp("tanks")
    scene_dir = root / "TankandTemples" / "intermediate"
    write_tanks_eval_tree(str(scene_dir), scenes=("Family",), nviews=NV,
                          height=H, width=W, baseline=3.0)
    pair = str(scene_dir / "Family" / "pair.txt")
    _, pairs = read_pair_file(pair)
    write_pair_file(pair, [pairs[0], pairs[5]])
    model = build_model(seed=3, device="cpu")
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
    ckpt = str(root / "model.pth")
    save_checkpoint(model, ckpt, epoch=2)
    return root, ckpt


def test_tanks_eval_cli_matches_jax_exact(tanks, tmp_path):
    root, ckpt = tanks
    common = ["-p", ckpt, "-d", "tanks", "-s", "intermediate", "--root",
              str(root), "--scans", "Family"]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_eval_main(common + ["-o", str(jax_out), "--exact"])
    stats = port_eval_main(common + ["-o", str(port_out), "--device", "cpu",
                                     "--exact"])
    assert stats["n_views"] == 1 and stats["first_map_sec"] > 0
    for ref in (0, 5):
        for sub in ("depth_est", "confidence"):
            name = os.path.join("Family", sub, f"{ref:08d}.pfm")
            (got, sg), (want, sw) = (read_pfm(str(port_out / name)),
                                     read_pfm(str(jax_out / name)))
            assert got.shape == want.shape == (H, W) and sg == sw
            if sub == "depth_est":
                # the port's CPU forward tolerance against JAX's f32 path
                # (tests/test_torch_eval_cli.py)
                err = depth_error(got, want)
                print(f"view {ref}: depth error median {np.median(err):.2e}"
                      f" max {err.max():.2e} of the range")
                assert np.median(err) <= 1e-5 and err.max() <= 1e-3
            else:
                np.testing.assert_allclose(got, want, atol=1e-4)
        assert (port_out / "Family" / "depth_est" / f"{ref:08d}.png").exists()


def test_tanks_eval_cli_without_a_card_fails(tanks, tmp_path, monkeypatch):
    root, ckpt = tanks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        port_eval_main(["-p", ckpt, "-d", "tanks", "--root", str(root),
                        "--scans", "Family", "-o", str(tmp_path / "out")])
    assert exit_info.value.code != 0
    assert not (tmp_path / "out").exists()
