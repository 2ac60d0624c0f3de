"""Remat in the port (``ModelConfig(remat=True)``: the backbone, each
aggregate and each U-Net checkpointed in training, ``models/core.py``)
against the plain step (twin of tests/test_train.py::
test_remat_step_matches_plain) and against JAX's remat step, on both train
paths, on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port_helpers import (SMALL, grad_errors, jax_train_oracle,
                                 port_from_jax, running_stats, train_batch)
from mdfnet_tpu_torch.models.layers import BatchNorm
from mdfnet_tpu_torch.train_lib import (batch_to_device, loss_and_grads,
                                        make_optimizer, train_step)

LR = 1e-3
REMAT = dataclasses.replace(SMALL, remat=True)


@pytest.fixture(scope="module")
def oracle():
    """JAX's remat step on test_torch_train.py's batch (one scene, twice)."""
    batch = train_batch(("steps", "steps"))
    return batch, jax_train_oracle(REMAT, batch)


@pytest.mark.parametrize("warp_impl", ["dense", "fused"])
def test_remat_step_equals_the_plain_step(oracle, warp_impl):
    """One Adam step with and without remat from the same weights: the
    loss within 1e-6, every parameter after the step within 1e-6, every
    running statistic (and update count) equal: recomputation updates
    nothing twice."""
    batch, want = oracle
    out = []
    for remat in (False, True):
        port = port_from_jax(SMALL, want["variables"], warp_impl=warp_impl,
                             remat=remat)
        assert port.remat == remat
        loss = train_step(port, make_optimizer(port, LR),
                          batch_to_device(batch, "cpu"))
        out.append((float(loss), dict(port.named_parameters()),
                    dict(port.named_buffers())))
    (l0, p0, b0), (l1, p1, b1) = out
    assert abs(l0 - l1) <= 1e-6, (l0, l1)
    for name, p in p0.items():
        torch.testing.assert_close(p1[name], p, rtol=0, atol=1e-6, msg=name)
    assert b0.keys() == b1.keys()
    for name, b in b0.items():
        assert torch.equal(b1[name], b), name


@pytest.mark.parametrize("warp_impl", ["dense", "fused"])
def test_remat_step_matches_jax_remat(oracle, warp_impl):
    """The port's remat step against JAX's (``nn.remat`` of the same
    blocks, exact XLA f32): tests/test_torch_train.py's bounds, the loss
    within 1e-5 relative, every gradient within 3e-3 relative error norm,
    every running statistic within 1e-5."""
    batch, want = oracle
    port = port_from_jax(SMALL, want["variables"], warp_impl=warp_impl,
                         remat=True)
    loss = loss_and_grads(port, batch_to_device(batch, "cpu"))
    assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    errs = grad_errors({k: p.grad.numpy() for k, p in
                        port.named_parameters()}, want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 3e-3, (worst, errs[worst])
    for name, buf in running_stats(dict(port.named_buffers())).items():
        np.testing.assert_allclose(buf.numpy(), want["stats"][name],
                                   atol=1e-5, err_msg=name)


def test_remat_recomputes_the_checkpointed_blocks(oracle):
    """The backward runs each checkpointed block's forward again, with its
    BatchNorms marked recomputing (and unmarked after); refine is not
    checkpointed."""
    batch, want = oracle
    port = port_from_jax(SMALL, want["variables"], remat=True)
    calls, marks = {}, {}
    for name in ("Backbone", "Homoaggre.0", "Regular.2", "Refine"):
        mod = port.get_submodule(name)
        norm = next((m for m in mod.modules() if isinstance(m, BatchNorm)),
                    BatchNorm(1))
        mod.register_forward_pre_hook(
            lambda _m, _a, name=name, norm=norm: (
                calls.__setitem__(name, calls.get(name, 0) + 1),
                marks.setdefault(name, []).append(norm.recomputing)) and None)
    loss_and_grads(port, batch_to_device(batch, "cpu"))
    assert calls == {"Backbone": 2, "Homoaggre.0": 2, "Regular.2": 2,
                     "Refine": 1}
    assert marks["Regular.2"] == [False, True]
    assert not any(m.recomputing for m in port.modules()
                   if isinstance(m, BatchNorm))


def test_remat_keeps_the_state_dict(oracle):
    _, want = oracle
    a = port_from_jax(SMALL, want["variables"]).state_dict()
    b = port_from_jax(SMALL, want["variables"], remat=True).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
