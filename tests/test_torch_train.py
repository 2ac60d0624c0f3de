"""The port's training step (plain versions, f32, on the CPU) vs the JAX
train step on its exact f32 XLA path (``warp_impl="gather"``): the loss,
every parameter's gradient, the updated BatchNorm running statistics and
the parameters after one Adam step; the LR schedule, the loss's empty mask,
and the train CLI on a tiny synthetic DTU tree."""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_helpers import SMALL, perturb_batchnorm
from mdfnet_tpu.data.synthetic import (make_batch, make_structured_scene,
                                       write_dtu_train_tree)
from mdfnet_tpu.models import build_model as build_jax_model
from mdfnet_tpu.models.loss import multi_scale_depth_loss as jax_loss
from mdfnet_tpu.train_lib import make_optimizer as jax_optimizer
from mdfnet_tpu.train_lib import poly_lr as jax_poly_lr
from mdfnet_tpu.utils.pth_import import variables_to_state_dict
from mdfnet_tpu_torch.models.loss import multi_scale_depth_loss
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.train import main as train_main
from mdfnet_tpu_torch.train_lib import (batch_to_device, loss_and_grads,
                                        make_optimizer, poly_lr)
from mdfnet_tpu_torch.utils.weights import (load_checkpoint,
                                            state_dict_from_jax_variables)

LR = 1e-3
NVIEWS, BATCH = 3, 2


def _state_dict(params, batch_stats):
    return variables_to_state_dict({
        "params": jax.tree_util.tree_map(np.asarray, params),
        "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)})


@pytest.fixture(scope="module")
def step():
    """One train step of each side from the same weights and batch: a
    32x64 scene with depth steps, 3 views, batch 2, SMALL widths."""
    scene = make_structured_scene(height=32, width=64, nviews=NVIEWS,
                                  structure="steps")
    batch = make_batch(scene, batch=BATCH)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jm = build_jax_model(dataclasses.replace(SMALL, warp_impl="gather"))
    variables = jax.jit(lambda b: jm.init(
        jax.random.PRNGKey(0), b["imgs"], b["extrinsics"], b["intrinsics"],
        b["depth_range"], train=True))(jb)
    variables = perturb_batchnorm(jax.tree_util.tree_map(np.asarray,
                                                         variables),
                                  np.random.RandomState(0))

    def loss_fn(params, stats, b):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": stats}, b["imgs"],
            b["extrinsics"], b["intrinsics"], b["depth_range"], train=True,
            mutable=["batch_stats"])
        return (jax_loss(out["depth"], b["ref_depths"], b["depth_range"]),
                mutated["batch_stats"])

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jb)
    # train_lib.optimizer_apply at epoch 1
    tx = jax_optimizer()
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    lr = float(jax_poly_lr(jnp.asarray(1), LR, 30, 0.9))
    new_params = optax.apply_updates(
        variables["params"], jax.tree_util.tree_map(lambda u: u * lr,
                                                    updates))
    want = {"loss": float(loss),
            "grads": _state_dict(grads, variables["batch_stats"]),
            "stats": _state_dict(variables["params"], stats),
            "params": _state_dict(new_params, variables["batch_stats"])}

    port = build_model(SMALL)
    port.load_state_dict(state_dict_from_jax_variables(variables),
                         strict=True)
    port.requires_grad_(True)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    got_loss = loss_and_grads(port, batch_to_device(batch, "cpu"))
    grads = {k: p.grad.clone() for k, p in port.named_parameters()}
    stats = {k: b.clone() for k, b in port.named_buffers()}
    make_optimizer(port, poly_lr(1, LR, 30, 0.9)).step()
    got = {"loss": float(got_loss), "grads": grads, "stats": stats,
           "params": dict(port.named_parameters()), "before": before}
    return got, want


def test_loss_matches_jax(step):
    got, want = step
    # measured |diff| 1.5e-4 of a loss of 407 (3.7e-7 relative): f32 sums
    # in other orders
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_every_gradient_matches_jax(step):
    """Each parameter's gradient within 3e-3 relative error norm (measured
    <= 4.2e-4, on the tiny DepthWeight gradients; the rest <= 1.5e-4):
    train-mode BN backprop amplifies f32 summation-order noise."""
    got, want = step
    params = {k for k in want["grads"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    assert set(got["grads"]) == params
    for name, g in got["grads"].items():
        ref = want["grads"][name]
        err = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert err <= 3e-3, (name, err)


def test_running_statistics_match_jax(step):
    """The mutated BN statistics, including the backbone's closed-form
    per-view EMA and DepthWeight's one update per source view; measured
    |diff| <= 2.9e-7."""
    got, want = step
    n_running = 0
    for name, buf in got["stats"].items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want["stats"][name],
                                       atol=1e-5, err_msg=name)
            n_running += 1
    assert n_running > 50
    counts = {k: int(v) for k, v in got["stats"].items()
              if k.endswith("num_batches_tracked")}
    assert counts["Backbone.conv01.0.bn.num_batches_tracked"] == NVIEWS
    assert counts["Homoaggre.1.depth_weight.0.bn.num_batches_tracked"] == \
        NVIEWS - 1
    assert counts["Regular.0.conv10.1.num_batches_tracked"] == 1


def test_adam_step_matches_optax(step):
    """The parameters after one Adam step vs optax's scale_by_adam. Adam's
    first step moves each element by ~lr * sign(grad), so an element whose
    gradient is noise-sized may move the other way: measured 39 of 1.07M
    elements beyond 1e-6 (bound: a 1e-4 share), none beyond 2 lr, and the
    update vectors' cosine 0.99999."""
    got, want = step
    upd_got, upd_want = [], []
    for name, p in got["params"].items():
        upd_got.append((p.detach() - got["before"][name]).numpy().ravel())
        upd_want.append((want["params"][name]
                         - got["before"][name].numpy()).ravel())
    a, b = np.concatenate(upd_got), np.concatenate(upd_want)
    diff = np.abs(a - b)
    assert diff.max() <= 2 * LR + 1e-7
    assert (diff > 1e-6).mean() <= 1e-4
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.9999


@pytest.mark.parametrize("epoch", [1, 7, 16, 30])
def test_poly_lr_matches_jax(epoch):
    want = float(jax_poly_lr(jnp.asarray(epoch), LR, 30, 0.9))
    assert poly_lr(epoch, LR, 30, 0.9) == pytest.approx(want, rel=1e-6)


def test_poly_lr_schedule():
    assert poly_lr(1, LR, 30, 0.9) == LR
    assert poly_lr(16, LR, 30, 0.9) == pytest.approx(LR * 0.5 ** 0.9)


def _pyramid(rng, b, h, w, lo=400.0, hi=900.0):
    return {k: rng.uniform(lo, hi, (b, h >> s, w >> s)).astype(np.float32)
            for k, s in (("3", 3), ("2", 2), ("1", 1), ("0", 0))}


def test_loss_matches_jax_with_masked_pixels():
    rng = np.random.RandomState(5)
    gt = _pyramid(rng, 2, 16, 32)                 # ~5% below dmin = 425
    depths = [gt[k] + rng.randn(*gt[k].shape).astype(np.float32) * 2.0
              for k in ("3", "2", "1", "0")]
    drange = np.array([[425.0, 935.0]] * 2, np.float32)
    want = float(jax_loss([jnp.asarray(d) for d in depths],
                          {k: jnp.asarray(v) for k, v in gt.items()},
                          jnp.asarray(drange)))
    got = multi_scale_depth_loss([torch.from_numpy(d) for d in depths],
                                 {k: torch.from_numpy(v)
                                  for k, v in gt.items()},
                                 torch.from_numpy(drange))
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_loss_on_an_empty_mask_is_zero_not_nan():
    """Every ground-truth pixel below dmin: the mean divides by max(count,
    1), so the loss is 0 with a zero gradient (the reference gives NaN)."""
    rng = np.random.RandomState(6)
    gt = {k: torch.from_numpy(v) for k, v in
          _pyramid(rng, 1, 8, 16, lo=0.0, hi=400.0).items()}
    depths = [torch.full_like(gt[k], 600.0, requires_grad=True)
              for k in ("3", "2", "1", "0")]
    loss = multi_scale_depth_loss(depths, gt, torch.tensor([[425.0, 935.0]]))
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert all(float(d.grad.abs().max()) == 0.0 for d in depths)


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    write_dtu_train_tree(str(root / "dtu640x512"), scans=(1,), nviews=4,
                         lightings=1, height=32, width=64)
    return root


def _cli(root, ckpt_dir, epochs, *extra):
    train_main(["-d", "dtu", "--root", str(root), "--scans", "1",
                "--lightings", "1", "--epochs", str(epochs), "--batch-size",
                "2", "--nviews", str(NVIEWS), "--ckpt-dir", str(ckpt_dir),
                *extra])


def test_train_cli_writes_loss_and_a_strict_checkpoint(dtu_tree, tmp_path):
    """Default (full) widths on a 32x64 tree: 4 items, 2 steps; the epoch
    loss is finite and dtu_1.pth loads strictly into the eval model."""
    _cli(dtu_tree, tmp_path, 1)
    losses = [float(v) for v in
              (tmp_path / "epoch_loss.txt").read_text().split()]
    assert len(losses) == 1 and math.isfinite(losses[0])
    ckpt = torch.load(tmp_path / "dtu_1.pth", weights_only=True)
    assert set(ckpt) == {"epoch", "model", "optimizer"}
    model = build_model(seed=3)
    assert load_checkpoint(model, str(tmp_path / "dtu_1.pth")) == 1
    imgs = torch.rand(1, NVIEWS, 32, 64, 3)
    k = torch.tensor([[115.2, 0, 32], [0, 115.2, 16], [0, 0, 1]])
    e = torch.eye(4).repeat(NVIEWS, 1, 1)
    e[:, 0, 3] = -torch.arange(NVIEWS) * 12.0
    out = model(imgs, e[None], k.repeat(1, NVIEWS, 1, 1),
                torch.tensor([[425.0, 935.0]]))
    assert out["depth"].shape == (1, 32, 64)
    assert bool(torch.isfinite(out["depth"]).all())


def test_train_cli_resumes_exactly(dtu_tree, tmp_path):
    """Two epochs in one run == one epoch, then a resume from dtu_1.pth
    (weights, BN statistics and Adam's moments) for the second."""
    straight, split = tmp_path / "straight", tmp_path / "split"
    _cli(dtu_tree, straight, 2)
    _cli(dtu_tree, split, 1)
    _cli(dtu_tree, split, 2, "-p", str(split / "dtu_1.pth"))
    a = torch.load(straight / "dtu_2.pth", weights_only=True)
    b = torch.load(split / "dtu_2.pth", weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    for name, v in a["model"].items():
        torch.testing.assert_close(b["model"][name], v, rtol=0, atol=0,
                                   msg=name)
    assert (straight / "epoch_loss.txt").read_text().split()[1] == \
        (split / "epoch_loss.txt").read_text().split()[1]
    assert os.path.exists(split / "dtu_1.pth")
