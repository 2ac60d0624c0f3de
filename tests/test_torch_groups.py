"""The vector aggregate at C/G != 2 (``ModelConfig(ngroups=...)`` with more
than two channels a group) in the port vs the JAX package's exact f32 XLA
path (``warp_impl="gather"``), on the CPU: the eval forward, the train step
on both train paths (``warp_impl="fused"`` takes the same path there), and
the eval path on the sample kernel's plain version against the gather
path it replaced."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port_helpers import (SMALL, depth_error, grad_errors,
                                 jax_model_and_port, jax_train_oracle,
                                 port_from_jax, running_stats, scene_args,
                                 to_torch, train_batch)
from mdfnet_tpu_torch.models.aggregate import VectorAggregate
from mdfnet_tpu_torch.ops.cuda import splat_kernel, warp_kernel
from mdfnet_tpu_torch.train_lib import batch_to_device, loss_and_grads

# SMALL's channels (32, 16, 8 at stages 0-2) in groups of 4
GROUPS = dataclasses.replace(SMALL, ngroups=(8, 4, 2))


@pytest.fixture(scope="module")
def eval_pair():
    args = scene_args(64, 96, nviews=3, structure="steps")
    jm, variables, port = jax_model_and_port(GROUPS, args)
    import jax
    ref = jax.jit(lambda *a: jm.apply(variables, *a, train=False))(*args)
    return args, port, {k: np.asarray(v) for k, v in ref.items()}


def test_groups_eval_forward_matches_jax(eval_pair):
    """test_corenet_matches_jax's bounds: depth error / range median <=
    1e-5, max <= 1e-3; confidence within 1e-4."""
    args, port, ref = eval_pair
    assert not port.Backbone.emit_diffs
    out = port(*to_torch(*args))
    err = depth_error(out["depth"].numpy(), ref["depth"])
    assert np.median(err) <= 1e-5 and err.max() <= 1e-3, \
        (np.median(err), err.max())
    np.testing.assert_allclose(out["confidence"].numpy(), ref["confidence"],
                               atol=1e-4)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_groups_eval_aggregate_on_the_sample_kernel(eval_pair, stage):
    """The eval aggregate on K6's plain version (what a CPU tensor runs)
    against the plain gather path (plain=True), both f32: the same
    bilinear taps, so equal to 1e-6 of the volume; no kernel launches."""
    args, port, _ = eval_pair
    rng = np.random.RandomState(stage)
    agg = port.Homoaggre[stage]
    c, h, w, d = GROUPS.chs[3 - stage], 16, 24, 6
    assert c == 4 * agg.ngroups
    feats = torch.from_numpy(rng.randn(1, 3, h, w, c).astype(np.float32))
    proj = torch.eye(4).repeat(1, 3, 1, 1)
    proj[:, :, 0, 0] = proj[:, :, 1, 1] = 1.5 * w
    proj[:, :, 0, 2], proj[:, :, 1, 2] = w / 2, h / 2
    proj[0, 1:, 0, 3] = torch.tensor([-20.0, 25.0]) * 1.5 * w / 100.0
    hyp = torch.linspace(425.0, 935.0, d).reshape(1, d, 1, 1)
    launches = dict(warp_kernel.LAUNCHES)
    got = agg(feats, proj[:, 0], proj[:, 1:], hyp)
    want = agg(feats, proj[:, 0], proj[:, 1:], hyp, plain=True)
    assert warp_kernel.LAUNCHES == launches
    assert got.shape == (1, d, h, w, agg.ngroups)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def train_oracle():
    batch = train_batch(("steps", "sphere"))
    return batch, jax_train_oracle(GROUPS, batch)


@pytest.mark.parametrize("warp_impl", ["dense", "fused"])
def test_groups_train_step_matches_jax(train_oracle, warp_impl):
    """Two distinct items (steps, sphere): the loss within 1e-5 relative
    and every running statistic within 1e-5 (tests/test_torch_train.py's
    bounds), the median parameter's gradient within 3e-4 relative error
    norm (measured 1.6e-5) and every parameter's within 0.1
    (tests/test_torch_alternatives_train.py's bounds). DepthWeight is
    updated once a source view. ``warp_impl="fused"`` at C/G != 2 runs the
    same path (JAX sends it to its dense warp).

    Not test_torch_train.py's 3e-3 for every parameter: stage 2's
    DepthWeight reads 2.4e-2 against JAX (-s prints the worst).
    DepthWeight's gradients cancel across the source views (sum_v w_v
    dL/dw_v = 0 at every voxel), so f32 rounding moves them by percents:
    swapping the two source views, which leaves the function unchanged,
    moves JAX's own gradient of that parameter by 1.6e-2 and the port's
    gap to JAX to 7.7e-3
    (test_depth_weight_gap_is_within_jax_own_spread). The gap is that
    noise, not a fault; 0.1 leaves 4x above the gap, 6x above JAX's
    spread."""
    batch, want = train_oracle
    port = port_from_jax(GROUPS, want["variables"], warp_impl=warp_impl)
    before = dict(splat_kernel.LAUNCHES)
    loss = loss_and_grads(port, batch_to_device(batch, "cpu"))
    assert splat_kernel.LAUNCHES == before      # CPU: the plain versions
    assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    errs = grad_errors(grads, want["grads"])
    assert np.median(list(errs.values())) <= 3e-4
    worst = max(errs, key=errs.get)
    print(f"{warp_impl}: worst {worst} {errs[worst]:.2e}, median "
          f"{np.median(list(errs.values())):.2e}")
    assert errs[worst] <= 0.1, (worst, errs[worst])
    for name, buf in running_stats(dict(port.named_buffers())).items():
        np.testing.assert_allclose(buf.numpy(), want["stats"][name],
                                   atol=1e-5, err_msg=name)
    assert int(port.state_dict()[
        "Homoaggre.0.depth_weight.0.bn.num_batches_tracked"]) == 2


def test_depth_weight_gap_is_within_jax_own_spread(train_oracle):
    """The port's worst gradient against JAX (stage 2's DepthWeight) is
    cancellation noise: a permutation of the source views leaves the
    aggregate (a weighted mean over the sources) unchanged but moves the
    f32 rounding, and JAX's own gradient then moves by as much (-s prints
    the readings: the gap 2.4e-2, JAX's spread 1.6e-2 on that parameter,
    the gap after the permutation 7.7e-3)."""
    batch, want = train_oracle
    views = [0, 2, 1]
    swapped = {k: (v[:, views] if k in ("imgs", "extrinsics", "intrinsics")
                   else v) for k, v in batch.items()}
    jax_swapped = jax_train_oracle(GROUPS, swapped)["grads"]
    spread = grad_errors(jax_swapped, want["grads"])

    def port_grads(b):
        port = port_from_jax(GROUPS, want["variables"])
        loss_and_grads(port, batch_to_device(b, "cpu"))
        return {k: p.grad.numpy() for k, p in port.named_parameters()}
    gap = grad_errors(port_grads(batch), want["grads"])
    gap_swapped = grad_errors(port_grads(swapped), jax_swapped)
    worst = max(gap, key=gap.get)
    print(f"worst {worst}: port vs JAX {gap[worst]:.2e}, JAX swapped vs "
          f"JAX {spread[worst]:.2e}, port vs JAX both swapped "
          f"{gap_swapped[worst]:.2e}; median spread "
          f"{np.median(list(spread.values())):.2e}")
    assert "depth_weight" in worst
    assert spread[worst] >= 1e-3            # the cancellation is real
    assert gap[worst] <= 2 * spread[worst]
    assert gap_swapped[worst] <= 2 * spread[worst]


def test_groups_fused_and_dense_train_give_the_same_bits(train_oracle):
    batch, want = train_oracle
    out = []
    for warp_impl in ("dense", "fused"):
        port = port_from_jax(GROUPS, want["variables"], warp_impl=warp_impl)
        loss = loss_and_grads(port, batch_to_device(batch, "cpu"))
        out.append((loss, [p.grad for p in port.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_groups_no_longer_raise_on_any_path():
    """Neither the eval path on a CUDA-style call nor training raises for
    C/G != 2: the aggregate has no NotImplementedError left."""
    import inspect
    from mdfnet_tpu_torch.models import aggregate
    assert "NotImplementedError" not in inspect.getsource(aggregate)
    agg = VectorAggregate(2)
    feats = torch.randn(1, 2, 8, 8, 8, requires_grad=True)
    proj = torch.eye(4)[None].repeat(1, 2, 1, 1) * 8.0
    proj[..., 3, 3] = 1.0
    vol = agg(feats, proj[:, 0], proj[:, 1:],
              torch.linspace(400.0, 900.0, 4).reshape(1, 4, 1, 1),
              train=True)
    vol.sum().backward()
    assert vol.shape == (1, 4, 8, 8, 2) and feats.grad is not None
