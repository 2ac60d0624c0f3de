"""The port's data-parallel plumbing (``mdfnet_tpu_torch/parallel``) against
the JAX package's: the data extent rule, the batch shards, the loss summed
over ranks against JAX's psum'd loss, the spawned ranks' failure handling,
and the train CLI on 2 gloo ranks on the CPU. The step itself:
tests/test_torch_parallel_step.py."""
import math
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dp_ranks import failing_rank, loss_rank, sleeping_rank
from _torch_port_helpers import train_batch
from mdfnet_tpu.data.synthetic import write_dtu_train_tree
from mdfnet_tpu.models.loss import multi_scale_depth_loss as jax_loss
from mdfnet_tpu.parallel import make_mesh
from mdfnet_tpu_torch.config import MeshConfig
from mdfnet_tpu_torch.parallel import (data_extent, data_world,
                                       default_backend, shard_batch,
                                       spawn_ranks)
from mdfnet_tpu_torch.utils.weights import load_checkpoint
from mdfnet_tpu_torch.models.registry import build_model

WORLD = 2


def _jax_rule(batch_size, n_devices):
    """mdfnet_tpu/train.py:47-52, as written there."""
    n = n_devices
    return max(k for k in range(1, min(n, batch_size) + 1)
               if batch_size % k == 0)


@pytest.mark.parametrize("batch_size,n_devices,want", [
    (4, 1, 1), (4, 2, 2), (4, 3, 2), (4, 4, 4), (4, 8, 4), (6, 4, 3),
    (6, 5, 3), (5, 4, 1), (1, 8, 1), (12, 8, 6), (6, 8, 6), (7, 8, 7)])
def test_data_world_is_jax_rule(batch_size, n_devices, want):
    assert data_world(batch_size, n_devices) == want
    assert _jax_rule(batch_size, n_devices) == want


def test_data_world_without_a_card_is_one():
    assert data_world(4, 0) == 1


def test_data_extent_reads_the_mesh_config():
    assert data_extent(MeshConfig(), 4, 8) == 4
    assert data_extent(MeshConfig(data_parallel=2), 4, 1) == 2
    with pytest.raises(ValueError):
        data_extent(MeshConfig(data_parallel=3), 4, 8)
    with pytest.raises(NotImplementedError):
        data_extent(MeshConfig(spatial_parallel=2), 4, 8)


def test_default_backend_without_a_card_per_rank_is_gloo():
    assert default_backend(2, "cpu") == "gloo"
    assert default_backend(torch.cuda.device_count() + 1, "cuda") == "gloo"


def test_shard_batch_takes_contiguous_items():
    """Rank r takes items [r B/n, (r+1) B/n) of every entry, where JAX's
    axis-0 NamedSharding places them; names (lists) and the GT pyramid
    (a dict) alike."""
    b = 4
    batch = {"imgs": np.arange(b * 3).reshape(b, 3),
             "ref_depths": {"0": torch.arange(b * 2).reshape(b, 2)},
             "names": [f"item{i}" for i in range(b)]}
    for rank in range(2):
        got = shard_batch(batch, rank, 2)
        np.testing.assert_array_equal(got["imgs"],
                                      batch["imgs"][2 * rank:2 * rank + 2])
        assert torch.equal(got["ref_depths"]["0"],
                           batch["ref_depths"]["0"][2 * rank:2 * rank + 2])
        assert got["names"] == batch["names"][2 * rank:2 * rank + 2]
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    placed = jax.device_put(jnp.asarray(batch["imgs"]),
                            jax.sharding.NamedSharding(mesh, P("data")))
    for shard in placed.addressable_shards:
        rank = mesh.devices.ravel().tolist().index(shard.device)
        np.testing.assert_array_equal(
            np.asarray(shard.data), shard_batch(batch, rank, 2)["imgs"])
    with pytest.raises(ValueError):
        shard_batch(batch, 0, 3)


def test_loss_summed_over_ranks_matches_jax_psum(tmp_path):
    """Shards with different valid-pixel counts (i columns of row 0 masked
    in item i) and different predictions: each rank's loss equals JAX's
    psum'd loss on 2 of the 8 CPU devices, and the single-process loss of
    the whole batch, within 1e-6 relative (twin of
    tests/test_train.py::test_loss_psum_matches_global_masked_mean)."""
    batch = train_batch(("steps", "sphere"))
    gt = {}
    for k, v in batch["ref_depths"].items():
        arr = v.copy()
        for i in range(2):
            arr[i, :1, :3 * i + 1] = 0.0
        gt[k] = arr
    depths = [gt[k] + np.linspace(0.5, 4.0, 2)[:, None, None]
              .astype(np.float32) for k in ("3", "2", "1", "0")]
    drange = batch["depth_range"]
    mesh = make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    fn = jax.shard_map(
        lambda d, g, r: jax_loss(d, g, r, axis_name="data"), mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")), out_specs=P(),
        check_vma=False)
    want = float(jax.jit(fn)([jnp.asarray(d) for d in depths],
                             {k: jnp.asarray(v) for k, v in gt.items()},
                             jnp.asarray(drange)))
    single = float(jax_loss([jnp.asarray(d) for d in depths],
                            {k: jnp.asarray(v) for k, v in gt.items()},
                            jnp.asarray(drange)))
    torch.save({"depths": [torch.from_numpy(d) for d in depths],
                "ref_depths": {k: torch.from_numpy(v) for k, v in gt.items()},
                "depth_range": torch.from_numpy(drange)}, tmp_path / "in.pt")
    spawn_ranks(loss_rank, WORLD, (f"file://{tmp_path}/pg",
                                   str(tmp_path / "in.pt"), str(tmp_path)),
                timeout=120)
    for rank in range(WORLD):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got == pytest.approx(want, rel=1e-6)
        assert got == pytest.approx(single, rel=1e-6)


def test_a_failed_rank_stops_the_others():
    """Rank 1 raises while rank 0 waits: the caller gets an error within
    seconds, and no rank is left running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1"):
        spawn_ranks(failing_rank, WORLD, timeout=120)
    assert time.monotonic() - t0 < 60


def test_hung_ranks_time_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_ranks(sleeping_rank, WORLD, timeout=5)
    assert time.monotonic() - t0 < 60


NVIEWS = 3
# one CLI run of 1-2 epochs takes ~25 s on 2 CPU ranks
CLI_TIMEOUT = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    write_dtu_train_tree(str(root / "dtu640x512"), scans=(1,), nviews=4,
                         lightings=1, height=32, width=64)
    return root


def _cli(root, ckpt_dir, epochs, *extra):
    """``python -m mdfnet_tpu_torch.train`` on 2 ranks, in a session of its
    own: past CLI_TIMEOUT seconds the whole session (the CLI and its ranks)
    is killed and the test fails, so no rank outlives it. Two threads a
    rank keep the ranks from crowding the other test workers."""
    cmd = [sys.executable, "-m", "mdfnet_tpu_torch.train", "-d", "dtu",
           "--root", str(root), "--scans", "1", "--lightings", "1",
           "--epochs", str(epochs), "--batch-size", "2", "--nviews",
           str(NVIEWS), "--ckpt-dir", str(ckpt_dir), "--device", "cpu",
           "--world-size", str(WORLD), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:]


def test_train_cli_on_two_ranks_resumes_exactly(dtu_tree, tmp_path):
    """--device cpu --world-size 2 (gloo): rank 0 alone writes one
    checkpoint an epoch and one epoch_loss.txt line; the checkpoint loads
    strictly into the eval model; two epochs in one run equal one epoch
    and a resume from dtu_1.pth on both ranks, bit for bit."""
    straight, split = tmp_path / "straight", tmp_path / "split"
    _cli(dtu_tree, split, 1)
    assert sorted(p.name for p in split.iterdir()) == ["dtu_1.pth",
                                                       "epoch_loss.txt"]
    losses = [float(v) for v in (split / "epoch_loss.txt").read_text()
              .split()]
    assert len(losses) == 1 and math.isfinite(losses[0])
    model = build_model(seed=3, device="cpu")
    assert load_checkpoint(model, str(split / "dtu_1.pth")) == 1
    _cli(dtu_tree, straight, 2)
    _cli(dtu_tree, split, 2, "-p", str(split / "dtu_1.pth"))
    a = torch.load(straight / "dtu_2.pth", weights_only=True)
    b = torch.load(split / "dtu_2.pth", weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    for name, v in a["model"].items():
        torch.testing.assert_close(b["model"][name], v, rtol=0, atol=0,
                                   msg=name)
    assert (straight / "epoch_loss.txt").read_text().split() == \
        (split / "epoch_loss.txt").read_text().split()
