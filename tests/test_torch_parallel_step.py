"""The port's data-parallel train step (``train_lib.train_step`` with a
process group) on 2 gloo ranks on the CPU, spawned, against JAX's
2-device ``shard_map`` step (``mdfnet_tpu/train_lib.py:shard_step``: the
loss psum'd inside, gradients and BatchNorm statistics pmean'd, on 2 of
the 8 virtual CPU devices) and against the port's one-process reference
(``train_lib.data_parallel_reference``); replicas after 2 steps; a dropped
gradient reduction. SMALL widths, 32x64 x 3 views, a global batch of 2
distinct items (one a shard)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_dp_ranks import step_rank
from _torch_port_helpers import (SMALL, grad_errors, jax_train_oracle,
                                 port_from_jax, running_stats, train_batch)
from mdfnet_tpu_torch.parallel import spawn_ranks
from mdfnet_tpu_torch.train_lib import batch_to_device, data_parallel_reference
from mdfnet_tpu_torch.utils.weights import state_dict_from_jax_variables

WORLD, LR = 2, 1e-3
# spawn, import, two steps and the collectives take ~10 s on the CPU
RANKS_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def oracle():
    batch = train_batch(("steps", "sphere"))
    return batch, jax_train_oracle(SMALL, batch, data=WORLD)


def run_ranks(tmp, oracle, warp_impl="dense", steps=1, fault=None):
    batch, want = oracle
    setup = {"config": dataclasses.asdict(dataclasses.replace(
                 SMALL, warp_impl=warp_impl)),
             "state_dict": state_dict_from_jax_variables(want["variables"]),
             "batch": batch_to_device(batch, "cpu"), "lr": LR,
             "steps": steps, "fault": fault}
    torch.save(setup, tmp / "setup.pt")
    spawn_ranks(step_rank, WORLD, (f"file://{tmp}/pg", str(tmp / "setup.pt"),
                                   str(tmp)), timeout=RANKS_TIMEOUT)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module", params=["dense", "fused"])
def ranks(request, oracle, tmp_path_factory):
    return request.param, run_ranks(tmp_path_factory.mktemp("ranks"), oracle,
                                    request.param, steps=2)


def _grads(result):
    return {k: v.numpy() for k, v in result["grads"].items()}


def test_dp_step_matches_jax_shard_map(ranks, oracle):
    """On both train paths (the port's fused path against JAX's exact
    dense path, as tests/test_torch_aggregate_train.py holds it): the loss
    within 1e-5 relative, every reduced gradient within 3e-3 relative error
    norm (measured <= 1.1e-3, DepthWeight's), every averaged running
    statistic within 1e-5, on each rank."""
    warp_impl, results = ranks
    _, want = oracle
    for got in results:
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        errs = grad_errors(_grads(got), want["grads"])
        assert set(errs) == {k for k in want["grads"]
                             if k in results[0]["grads"]}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 3e-3, (warp_impl, worst, errs[worst])
        for name, buf in running_stats(got["buffers"]).items():
            np.testing.assert_allclose(buf.numpy(), want["stats"][name],
                                       atol=1e-5, err_msg=name)
    # each rank's DepthWeight took its 2 source views' updates
    assert int(results[0]["buffers"][
        "Homoaggre.1.depth_weight.0.bn.num_batches_tracked"]) == 2


@pytest.fixture(scope="module")
def reference(oracle):
    """The port's one-process reference of the same step: each shard's
    forward in turn with its own statistics, the global loss's gradient,
    the statistics averaged."""
    batch, want = oracle
    out = {}
    for warp_impl in ("dense", "fused"):
        port = port_from_jax(SMALL, want["variables"], warp_impl=warp_impl)
        loss = data_parallel_reference(port, batch_to_device(batch, "cpu"),
                                       WORLD)
        out[warp_impl] = {
            "loss": float(loss),
            "grads": {k: p.grad.numpy() for k, p in port.named_parameters()},
            "buffers": dict(port.named_buffers())}
    return out


def test_dp_step_matches_the_one_process_reference(ranks, reference):
    """The ranks' collectives against the same semantics in one process:
    the loss within 1e-6 relative, every gradient within 2e-3 relative
    error norm (the shards' shares summed by the all-reduce, not by
    autograd; measured <= 4.5e-4, a DepthWeight bias whose gradient
    cancels across views, the median ~1e-6), the running statistics
    within 1e-6 (the same per-shard updates averaged; measured 1.2e-7, the
    reductions of another thread count)."""
    warp_impl, results = ranks
    want = reference[warp_impl]
    for got in results:
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
        errs = grad_errors(_grads(got), want["grads"])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 2e-3, (worst, errs[worst])
        assert np.median(list(errs.values())) <= 1e-5
        for name, buf in got["buffers"].items():
            torch.testing.assert_close(buf, want["buffers"][name], rtol=0,
                                       atol=1e-6)


def test_replicas_stay_bit_equal(ranks):
    """After each of 2 steps, every parameter, buffer and Adam moment is
    the same on both ranks, bit for bit."""
    _, results = ranks
    assert len(results[0]["digests"]) == 2
    assert results[0]["digests"] == results[1]["digests"]


def test_a_dropped_gradient_reduction_fails_the_comparison(
        oracle, reference, tmp_path):
    """Rank 0 joins the all-reduce but keeps its own shard's gradients:
    the comparison with JAX reads that at >= 2x its bound (3e-3), and the
    replicas part after the step."""
    _, want = oracle
    results = run_ranks(tmp_path, oracle, fault=0)
    errs = grad_errors(_grads(results[0]), want["grads"])
    assert max(errs.values()) >= 2 * 3e-3, max(errs.values())
    ok = grad_errors(_grads(results[1]), want["grads"])
    assert max(ok.values()) <= 3e-3
    assert results[0]["digests"] != results[1]["digests"]
