"""The alternative units' train step in the port vs the JAX package's exact
f32 XLA path (``warp_impl="gather"``), on the CPU;
``tests/test_torch_alternatives.py`` holds their functions, eval forwards,
parameter counts and weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_helpers import (ALTERNATIVES, alternative, build_port,
                                 perturb_batchnorm)
from mdfnet_tpu.data.synthetic import make_batch, make_structured_scene
from mdfnet_tpu.models import build_model as build_jax_model
from mdfnet_tpu.models.loss import multi_scale_depth_loss as jax_loss
from mdfnet_tpu_torch.train_lib import batch_to_device, loss_and_grads
from mdfnet_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                            state_dict_from_jax_variables)


NVIEWS, BATCH = 3, 2


def _train_step_pair(name):
    """One train step of each side from the same weights and batch (32x64,
    depth steps, 3 views, batch 2, SMALL widths): the loss and every
    parameter's gradient."""
    scene = make_structured_scene(height=32, width=64, nviews=NVIEWS,
                                  structure="steps")
    batch = make_batch(scene, batch=BATCH)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jm = build_jax_model(dataclasses.replace(alternative(name),
                                             warp_impl="gather"))
    variables = jax.jit(lambda b: jm.init(
        jax.random.PRNGKey(0), b["imgs"], b["extrinsics"], b["intrinsics"],
        b["depth_range"], train=True))(jb)
    variables = perturb_batchnorm(jax.tree_util.tree_map(np.asarray,
                                                         variables),
                                  np.random.RandomState(0))

    def loss_fn(params, stats, b):
        out, _ = jm.apply(
            {"params": params, "batch_stats": stats}, b["imgs"],
            b["extrinsics"], b["intrinsics"], b["depth_range"], train=True,
            mutable=["batch_stats"])
        return jax_loss(out["depth"], b["ref_depths"], b["depth_range"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], variables["batch_stats"], jb)
    want = jax_variables_to_state_dict({
        "params": jax.tree_util.tree_map(np.asarray, grads),
        "batch_stats": variables["batch_stats"]})
    port = build_port(alternative(name))
    port.load_state_dict(state_dict_from_jax_variables(variables),
                         strict=True)
    port.requires_grad_(True)
    got_loss = loss_and_grads(port, batch_to_device(batch, "cpu"))
    return (float(got_loss), {k: p.grad for k, p in port.named_parameters()},
            float(loss), want)


@pytest.mark.parametrize("name", list(ALTERNATIVES))
def test_alternative_train_step_matches_jax(name):
    """The loss within 1e-5 relative (test_torch_train.py's bound), the
    median parameter's gradient within 3e-4 relative error norm (measured
    1.3e-5 to 5.6e-5) and every parameter's within 0.1.

    The last is wider than the default config's 3e-3 because these units'
    gradients are ill-conditioned in f32, measured here on the same
    inputs: a random 1e-7 relative change of the posterior fed to the
    hypotheses (ATV's band, the gauss0 and laplace fits) moves a stage's
    DepthWeight and first U-Net gradients by up to 9.4e-3, and noise of
    1e-7 (4e-6) in the variance volume moves the stage-0 U-Net's by 0.6%
    (9.5%): its values span 1e-8 to 0.6, and the port's and JAX's forward
    volumes differ by 4.3e-6. Worst readings: variance 7.6e-3, atv 1.9e-2,
    refine1 3.8e-4, gauss0 8.0e-3, all four 5.3e-2 (the stage-0 U-Net's
    and the backbone's BatchNorms)."""
    got_loss, grads, loss, want = _train_step_pair(name)
    assert got_loss == pytest.approx(loss, rel=1e-5)
    assert set(grads) == {k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    errs = {k: np.linalg.norm(g.numpy() - want[k]) / np.linalg.norm(want[k])
            for k, g in grads.items()}
    assert np.median(list(errs.values())) <= 3e-4, np.median(
        list(errs.values()))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.1, (worst, errs[worst])
