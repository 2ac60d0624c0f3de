"""The eval loop and CLI with the image height sharded over 2 gloo ranks on
the CPU (``run_eval(..., spatial=2)``, ``cli.eval --spatial 2 --device
cpu``): the same PFMs as the unsharded loop (the twin of JAX
test_spatial.py:99-133), written by rank 0 alone."""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from _torch_port_helpers import SMALL, build_port, depth_error
from mdfnet_tpu_torch.data import DTUEvalDataset, write_dtu_eval_tree
from mdfnet_tpu_torch.data.formats import read_pfm
from mdfnet_tpu_torch.evaluate import run_eval
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.utils.weights import save_checkpoint

# spawn, import, 4 forwards and the writes take ~10 s on 2 CPU ranks; the
# CLI adds its own start and the model's build
SPAWN_TIMEOUT, CLI_TIMEOUT = 120, 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _same_maps(a: str, b: str) -> None:
    """Equal file lists; depth PFMs within 1e-5 of the range at most,
    confidence within 1e-4 (test_spatial.py's bounds)."""
    files = _files(a)
    assert files == _files(b)
    for name in files:
        if not name.endswith(".pfm"):
            continue
        (pa, sa), (pb, sb) = (read_pfm(os.path.join(a, name)),
                              read_pfm(os.path.join(b, name)))
        assert pa.shape == pb.shape and sa == sb, name
        bound = 1e-5 if "depth_est" in name else 1e-4
        err = (depth_error(pa, pb) if "depth_est" in name
               else np.abs(pa - pb))
        assert err.max() <= bound, (name, err.max())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    write_dtu_eval_tree(str(root / "dtu1600x1200"), scans=(9,), nviews=4,
                        height=64, width=96, baseline=4.0)
    return root


def test_run_eval_spatial_matches_unsharded(tree, tmp_path):
    dataset = DTUEvalDataset(str(tree / "dtu1600x1200"), scans=[9],
                             nviews=4, crop_height=64)
    model = build_port(SMALL, seed=1)
    ref, sp = str(tmp_path / "ref"), str(tmp_path / "sp")
    run_eval(model, dataset, ref)
    stats = run_eval(model, dataset, sp, spatial=2, timeout=SPAWN_TIMEOUT)
    assert len(_files(sp)) == 12             # 4 views x 3 files, once
    assert stats["n_views"] == 3 and stats["first_map_sec"] > 0
    _same_maps(sp, ref)


def test_run_eval_spatial_refuses_a_misaligned_height(tree, tmp_path):
    dataset = DTUEvalDataset(str(tree / "dtu1600x1200"), scans=[9],
                             nviews=4, crop_height=48)
    with pytest.raises(ValueError, match="multiple"):
        run_eval(build_port(SMALL), dataset, str(tmp_path), spatial=2)


def _cli(*args) -> str:
    """``python -m mdfnet_tpu_torch.cli.eval`` in a session of its own:
    past CLI_TIMEOUT seconds the session (the CLI and its ranks) is killed
    and the test fails, so no rank outlives it."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-m", "mdfnet_tpu_torch.cli.eval",
                             *args], cwd=REPO, env=env,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:]
    return out


def test_eval_cli_spatial_2_on_the_cpu(tree, tmp_path):
    """--device cpu --spatial 2 (gloo; the 1184 crop aligned to 1152, which
    leaves the 64-row synthetic images whole) writes the maps that the
    unsharded CLI writes."""
    ckpt = str(tmp_path / "model.pth")
    save_checkpoint(build_model(seed=2, device="cpu"), ckpt)
    common = ["-p", ckpt, "--root", str(tree), "--scans", "9", "--device",
              "cpu"]
    ref, sp = str(tmp_path / "ref"), str(tmp_path / "sp")
    _cli(*common, "-o", ref)
    log = _cli(*common, "-o", sp, "--spatial", "2")
    assert "crop height 1184 -> 1152" in log
    assert len(_files(sp)) == 12
    _same_maps(sp, ref)
