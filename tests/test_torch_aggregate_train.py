"""The fused train aggregate (K9): the plain stats kernel and the plain
train K1 vs the TPU kernels in Pallas interpret mode; the port's fused train
aggregate (plain versions, f32) vs the JAX VectorAggregate on its exact dense
and gather paths in train mode; the CoreNet train step with
``warp_impl="fused"`` vs the JAX XLA f32 step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (SMALL, build_port, perturb_batchnorm,
                                 to_torch)
from mdfnet_tpu import geometry as jgeo
from mdfnet_tpu.data.synthetic import make_batch, make_structured_scene
from mdfnet_tpu.models import build_model as build_jax_model
from mdfnet_tpu.models.aggregate import VectorAggregate as JaxVectorAggregate
from mdfnet_tpu.models.loss import multi_scale_depth_loss as jax_loss
from mdfnet_tpu.ops.pallas.aggregate_kernel import (rowsweep_aggregate as
                                                    pallas_rowsweep,
                                                    rowsweep_cover,
                                                    rowsweep_stats as
                                                    pallas_stats)
from mdfnet_tpu.utils.pth_import import variables_to_state_dict
from mdfnet_tpu_torch.models.aggregate import VectorAggregate
from mdfnet_tpu_torch.ops.aggregate_train import rowsweep_aggregate_train
from mdfnet_tpu_torch.ops.cuda import aggregate_kernel
from mdfnet_tpu_torch.train_lib import batch_to_device, loss_and_grads
from mdfnet_tpu_torch.utils.weights import state_dict_from_jax_variables


def _cameras(v, h, w, roll=0.0):
    """Cameras translated along x (MVS-style); ``roll`` (radians) also turns
    view i by i * roll about its optical axis, so that a reference row maps
    onto a slanted source line."""
    intr = np.tile(np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                            np.float32), (1, v, 1, 1))
    extr = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    for i in range(1, v):
        c, s = np.cos(i * roll), np.sin(i * roll)
        extr[0, i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        extr[:, i, 0, 3] = i * 2.0
        extr[:, i, 1, 3] = (i % 2) * 0.7
    ref_proj, src_projs = jgeo.projection_matrices(jnp.asarray(intr),
                                                   jnp.asarray(extr), stage=3)
    return np.asarray(ref_proj), np.asarray(src_projs)


def _hypos(rng, b, d, h, w, per_pixel, lo=420.0, hi=700.0):
    planes = np.linspace(lo, hi, d, dtype=np.float32).reshape(1, d, 1, 1)
    planes = np.repeat(planes, b, 0)
    if not per_pixel:
        return planes
    return planes + rng.rand(b, d, h, w).astype(np.float32) * 5.0


# ------------------------------------------------- plain kernels vs Pallas

def test_plain_stats_and_train_k1_match_pallas_interpret():
    """One batch item, 2 sources, the TPU kernels' window contract holding.
    The TPU kernels run their x-interpolation matmul in bf16
    (aggregate_kernel.py:147-150), hence bf16-level tolerances: the volume
    and weight sum as the eval K1 test; the sums of s and s^2 within 2e-2
    relative."""
    rng = np.random.RandomState(21)
    v, h, w, c, d = 3, 8, 16, 8, 3
    g = c // 2
    ref_proj, src_projs = _cameras(v, h, w)
    hyp = _hypos(rng, 1, d, h, w, per_pixel=True)
    diffs = (rng.randn(v, h, w, g) * 0.5).astype(np.float32)
    k0 = (rng.randn(g) * 0.3).astype(np.float32)
    bn_s = np.array([0.9, 1.3], np.float32)
    bn_o = np.array([0.1, -0.2], np.float32)
    k1, b1 = np.float32(1.2), np.float32(-0.2)
    assert bool(rowsweep_cover(src_projs[0], ref_proj[0], hyp[0], h, w))
    diffs_hcw = jnp.asarray(diffs.transpose(0, 1, 3, 2))       # (V, H, G, W)
    q_hcw = jax.nn.sigmoid(diffs_hcw[0])
    sums, count, cover = pallas_stats(diffs_hcw[1:], q_hcw, src_projs[0],
                                      ref_proj[0], jnp.asarray(hyp[0]),
                                      jnp.asarray(k0), interpret=True)
    vol, wsum, cover2 = pallas_rowsweep(
        diffs_hcw[1:], q_hcw, src_projs[0], ref_proj[0], jnp.asarray(hyp[0]),
        jnp.asarray(k0), jnp.asarray(bn_s), jnp.asarray(bn_o), k1, b1,
        interpret=True, with_wsum=True)
    assert bool(cover) and bool(cover2) and count == d * h * w
    args = to_torch(diffs[None, 1:], diffs[None, 0], src_projs, ref_proj, hyp,
                    k0)
    got_sums = aggregate_kernel.rowsweep_stats(*args)
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums),
                               rtol=2e-2, atol=2e-2)
    got_vol, got_wsum = aggregate_kernel.rowsweep_aggregate_with_wsum(
        *args, *to_torch(bn_s, bn_o), torch.tensor(k1), torch.tensor(b1))
    np.testing.assert_allclose(
        got_vol.numpy(), np.asarray(vol)[..., :w].transpose(0, 1, 3, 2)[None],
        atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(got_wsum.numpy(),
                               np.asarray(wsum)[..., :w][None],
                               atol=2e-3, rtol=2e-2)


def test_cpu_wrappers_launch_nothing():
    """CPU tensors take the plain versions: no build, counters unchanged."""
    rng = np.random.RandomState(22)
    ref_proj, src_projs = _cameras(3, 8, 16)
    diffs = rng.randn(1, 3, 8, 16, 8).astype(np.float32)
    args = to_torch(diffs[:, 1:], diffs[:, 0], src_projs, ref_proj,
                    _hypos(rng, 1, 3, 8, 16, False),
                    rng.randn(8).astype(np.float32))
    before = dict(aggregate_kernel.LAUNCHES)
    torch.testing.assert_close(aggregate_kernel.rowsweep_stats(*args),
                               aggregate_kernel.rowsweep_stats_plain(*args))
    bn = (torch.ones(2), torch.zeros(2), torch.tensor(1.0), torch.tensor(0.0))
    aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn)
    rowsweep_aggregate_train(*args, torch.ones(1), torch.zeros(1),
                             torch.tensor(1.0), torch.tensor(0.0))
    assert aggregate_kernel.LAUNCHES == before


# ------------------------------------- the fused train aggregate vs JAX XLA

def _load_depth_weight(port: VectorAggregate, variables):
    p = variables["params"]["depth_weight"]
    st = variables["batch_stats"]["depth_weight"]["bn0"]
    sd = {"0.conv.weight": p["conv0"]["kernel"].transpose(4, 3, 0, 1, 2),
          "0.bn.weight": p["bn0"]["scale"], "0.bn.bias": p["bn0"]["bias"],
          "0.bn.running_mean": st["mean"], "0.bn.running_var": st["var"],
          "0.bn.num_batches_tracked": np.zeros((), np.int64),
          "1.weight": p["conv1"]["kernel"].transpose(4, 3, 0, 1, 2),
          "1.bias": p["conv1"]["bias"]}
    port.depth_weight.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=True)


def _jax_train_aggregate(rng, feats, ref_proj, src_projs, hyp, g, impl, cot):
    """The JAX VectorAggregate in train mode on an exact XLA path: volume,
    mutated batch stats, and the vjp of <volume, cot> in every parameter
    and every view's features."""
    views = [jnp.asarray(feats[:, i]) for i in range(feats.shape[1])]
    agg = JaxVectorAggregate(g, dtype=jnp.float32, warp_impl=impl)
    variables = agg.init(jax.random.PRNGKey(0), views, ref_proj, src_projs,
                         jnp.asarray(hyp), train=True)
    variables = perturb_batchnorm(jax.tree_util.tree_map(np.asarray,
                                                         variables), rng)

    def run(params, views):
        return agg.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         views, ref_proj, src_projs, jnp.asarray(hyp),
                         train=True, mutable=["batch_stats"])
    vol, mutated = run(variables["params"], views)
    _, pull = jax.vjp(lambda p, vs: run(p, vs)[0], variables["params"], views)
    d_params, d_views = pull(jnp.asarray(cot))
    return (variables, np.asarray(vol), mutated["batch_stats"],
            jax.tree_util.tree_map(np.asarray, d_params),
            np.stack([np.asarray(x) for x in d_views], axis=1))


def _port_train_aggregate(variables, feats, ref_proj, src_projs, hyp, g,
                          cot):
    port = VectorAggregate(g, warp_impl="fused")
    _load_depth_weight(port, variables)
    f = torch.from_numpy(feats).requires_grad_(True)
    vol = port(f, *to_torch(ref_proj, src_projs, hyp), train=True)
    vol.backward(torch.from_numpy(cot))
    grads = {k: p.grad.numpy() for k, p in port.depth_weight.named_parameters()}
    return port, vol.detach().numpy(), grads, f.grad.numpy()


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(np.asarray(b, np.float64)))


def _check_against_jax(rng, feats, ref_proj, src_projs, hyp, g, impl):
    cot = rng.randn(*((feats.shape[0], hyp.shape[1]) + feats.shape[2:4]
                      + (g,))).astype(np.float32)
    variables, vol, stats, d_params, d_feats = _jax_train_aggregate(
        rng, feats, ref_proj, src_projs, hyp, g, impl, cot)
    port, got_vol, grads, got_feats = _port_train_aggregate(
        variables, feats, ref_proj, src_projs, hyp, g, cot)
    # f32 on both sides: summation order only
    np.testing.assert_allclose(got_vol, vol, atol=1e-5, rtol=1e-5)
    bn = port.depth_weight[0].bn
    st = stats["depth_weight"]["bn0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), st["var"], atol=1e-6)
    assert int(bn.num_batches_tracked) == feats.shape[1] - 1
    p = d_params["depth_weight"]
    want = {"0.conv.weight": p["conv0"]["kernel"].transpose(4, 3, 0, 1, 2),
            "0.bn.weight": p["bn0"]["scale"], "0.bn.bias": p["bn0"]["bias"],
            "1.weight": p["conv1"]["kernel"].transpose(4, 3, 0, 1, 2),
            "1.bias": p["conv1"]["bias"]}
    # the batch-statistics BN backward cancels means over every voxel: the
    # scalar parameters' gradients carry f32 summation noise (JAX sums in
    # f32, the port in f64); measured <= 2.2e-4, the features' <= 5e-6
    errs = {name: _rel(grads[name], ref) for name, ref in want.items()}
    errs["features"] = _rel(got_feats, d_feats)
    for name, err in errs.items():
        assert err <= 1e-3, (name, err)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_fused_train_aggregate_matches_jax_dense(per_pixel):
    """Against JAX's dense path (exact for these MVS-style cameras), which
    computes the same math as the fused path in f32: the volume, the
    running statistics and every gradient."""
    rng = np.random.RandomState(23 + per_pixel)
    b, v, h, w, c, d = 2, 4, 12, 20, 8, 5
    feats = (rng.randn(b, v, h, w, c) * 0.5).astype(np.float32)
    ref_proj, src_projs = _cameras(v, h, w)
    ref_proj = np.repeat(ref_proj, b, 0)
    src_projs = np.repeat(src_projs, b, 0)
    hyp = _hypos(rng, b, d, h, w, per_pixel)
    _check_against_jax(rng, feats, ref_proj, src_projs, hyp, c // 2, "dense")


def test_fused_train_aggregate_exact_for_a_20_degree_camera():
    """20 degrees of roll between views: a reference row crosses more
    source rows than the TPU fused kernel's y-band holds, so its window
    contract fails (rowsweep_cover is False), and the port's fused path
    still matches JAX's exact gather path."""
    rng = np.random.RandomState(25)
    b, v, h, w, c, d = 1, 3, 12, 20, 8, 5
    feats = (rng.randn(b, v, h, w, c) * 0.5).astype(np.float32)
    ref_proj, src_projs = _cameras(v, h, w, roll=0.35)
    hyp = _hypos(rng, b, d, h, w, False)
    assert not bool(rowsweep_cover(src_projs[0], ref_proj[0], hyp[0], h, w))
    _check_against_jax(rng, feats, ref_proj, src_projs, hyp, c // 2,
                       "gather")


# ------------------------------------------------ the CoreNet train step

NVIEWS, BATCH = 3, 2


def _state_dict(params, batch_stats):
    return variables_to_state_dict({
        "params": jax.tree_util.tree_map(np.asarray, params),
        "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)})


@pytest.fixture(scope="module")
def fused_step():
    """One train step at SMALL widths (32x64 scene with depth steps, 3
    views, batch 2): the JAX XLA f32 step on the dense warp, and the port's
    step with warp_impl="fused" on the plain versions."""
    scene = make_structured_scene(height=32, width=64, nviews=NVIEWS,
                                  structure="steps")
    batch = make_batch(scene, batch=BATCH)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jm = build_jax_model(dataclasses.replace(SMALL, warp_impl="dense"))
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
    want = {"loss": float(loss),
            "grads": _state_dict(grads, variables["batch_stats"]),
            "stats": _state_dict(variables["params"], stats)}
    port = build_port(dataclasses.replace(SMALL, warp_impl="fused"))
    port.load_state_dict(state_dict_from_jax_variables(variables),
                         strict=True)
    port.requires_grad_(True)
    got_loss = loss_and_grads(port, batch_to_device(batch, "cpu"))
    got = {"loss": float(got_loss),
           "grads": {k: p.grad.clone() for k, p in port.named_parameters()},
           "stats": {k: b.clone() for k, b in port.named_buffers()}}
    return got, want


def test_fused_step_loss_matches_jax(fused_step):
    got, want = fused_step
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def test_fused_step_every_gradient_matches_jax(fused_step):
    """Each parameter's gradient within 1e-3 relative error norm: f32
    summation order, amplified by the train-mode BN backprop."""
    got, want = fused_step
    assert len(got["grads"]) > 100
    for name, g in got["grads"].items():
        assert _rel(g.numpy(), want["grads"][name]) <= 1e-3, name


def test_fused_step_running_statistics_match_jax(fused_step):
    """Every BN's running statistics after the step, including DepthWeight's
    V - 1 updates replayed from the stats kernel's batch statistics."""
    got, want = fused_step
    for name, buf in got["stats"].items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want["stats"][name],
                                       atol=1e-5, err_msg=name)
    assert int(got["stats"][
        "Homoaggre.0.depth_weight.0.bn.num_batches_tracked"]) == NVIEWS - 1
