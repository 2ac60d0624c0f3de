"""The fused aggregate (K1): its plain PyTorch version vs the TPU kernel in
Pallas interpret mode and vs the JAX VectorAggregate on the exact gather
warp; the port's VectorAggregate and DepthWeight."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import perturb_batchnorm, to_torch
from mdfnet_tpu import geometry as jgeo
from mdfnet_tpu.models.aggregate import VectorAggregate as JaxVectorAggregate
from mdfnet_tpu.ops.pallas.aggregate_kernel import (rowsweep_aggregate as
                                                    pallas_rowsweep,
                                                    rowsweep_cover)
from mdfnet_tpu_torch.models.aggregate import DepthWeight, VectorAggregate
from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import (
    depth_weight_folded, rowsweep_aggregate, rowsweep_aggregate_plain)


def _scene(rng, v, h, w, c):
    """Per-view features and cameras translated along x (MVS-style)."""
    feats = rng.randn(1, v, h, w, c).astype(np.float32) * 0.5
    intr = np.tile(np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                            np.float32), (1, v, 1, 1))
    extr = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    for i in range(1, v):
        extr[:, i, 0, 3] = i * 2.0
        extr[:, i, 1, 3] = (i % 2) * 0.7
    ref_proj, src_projs = jgeo.projection_matrices(jnp.asarray(intr),
                                                   jnp.asarray(extr), stage=3)
    return feats, np.asarray(ref_proj), np.asarray(src_projs)


def _hypos(rng, d, h, w, per_pixel):
    planes = np.linspace(420.0, 700.0, d, dtype=np.float32)
    if not per_pixel:
        return planes.reshape(1, d, 1, 1)
    return (planes.reshape(1, d, 1, 1)
            + rng.rand(1, d, h, w).astype(np.float32) * 5.0)


def _jax_aggregate(rng, feats, ref_proj, src_projs, hyp, g):
    """The JAX VectorAggregate (gather warp) with perturbed DepthWeight BN."""
    views = [jnp.asarray(feats[:, i]) for i in range(feats.shape[1])]
    agg = JaxVectorAggregate(g, dtype=jnp.float32, warp_impl="gather")
    variables = agg.init(jax.random.PRNGKey(0), views, ref_proj, src_projs,
                         jnp.asarray(hyp))
    variables = perturb_batchnorm(jax.tree_util.tree_map(np.asarray,
                                                         variables), rng)
    out = agg.apply(variables, views, ref_proj, src_projs, jnp.asarray(hyp))
    return variables, np.asarray(out)


def _load_depth_weight(port: DepthWeight, variables):
    """Copy the JAX DepthWeight's parameters into the port's module."""
    p = variables["params"]["depth_weight"]
    st = variables["batch_stats"]["depth_weight"]["bn0"]
    sd = {"0.conv.weight": p["conv0"]["kernel"].transpose(4, 3, 0, 1, 2),
          "0.bn.weight": p["bn0"]["scale"], "0.bn.bias": p["bn0"]["bias"],
          "0.bn.running_mean": st["mean"], "0.bn.running_var": st["var"],
          "0.bn.num_batches_tracked": np.zeros((), np.int64),
          "1.weight": p["conv1"]["kernel"].transpose(4, 3, 0, 1, 2),
          "1.bias": p["conv1"]["bias"]}
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plain_matches_pallas_interpret(per_pixel):
    """Plain K1 vs the TPU kernel (interpret mode) where its window
    contract holds. The TPU kernel runs its x-interpolation matmul in bf16
    (aggregate_kernel.py:147-150), hence the bf16-level tolerance."""
    rng = np.random.RandomState(11)
    v, h, w, c, d = 3, 16, 32, 8, 4
    feats, ref_proj, src_projs = _scene(rng, v, h, w, c)
    hyp = _hypos(rng, d, h, w, per_pixel)
    diffs = feats[0, ..., 0::2] - feats[0, ..., 1::2]          # (V, H, W, G)
    k0 = rng.randn(c // 2).astype(np.float32) * 0.3
    scalars = (0.9, 0.1, 1.2, -0.2)                 # bn_s, bn_o, k1, b1
    assert bool(rowsweep_cover(src_projs[0], ref_proj[0], hyp[0], h, w))
    diffs_hcw = jnp.asarray(diffs.transpose(0, 1, 3, 2))      # (V, H, G, W)
    ref, cover = pallas_rowsweep(diffs_hcw[1:], jax.nn.sigmoid(diffs_hcw[0]),
                                 src_projs[0], ref_proj[0],
                                 jnp.asarray(hyp[0]), jnp.asarray(k0),
                                 *scalars, interpret=True)
    assert bool(cover)
    ref = np.asarray(ref)[..., :w].transpose(0, 1, 3, 2)[None]  # (1,D,H,W,G)
    got = rowsweep_aggregate_plain(
        *to_torch(diffs[None, 1:], diffs[None, 0], src_projs, ref_proj, hyp,
                  k0), *map(torch.tensor, scalars))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("cg", [2, 4])
def test_vector_aggregate_matches_jax_gather(per_pixel, cg):
    """The port's VectorAggregate (C/G == 2: the K1 wrapper on CPU, i.e. the
    plain version; C/G == 4: the group-softmax path) vs JAX's on the exact
    gather warp. Both f32: only summation order differs."""
    rng = np.random.RandomState(12 + cg)
    v, h, w, c, d = 4, 12, 20, 8, 5
    g = c // cg
    feats, ref_proj, src_projs = _scene(rng, v, h, w, c)
    hyp = _hypos(rng, d, h, w, per_pixel)
    variables, ref = _jax_aggregate(rng, feats, ref_proj, src_projs, hyp, g)
    port = VectorAggregate(g).requires_grad_(False)
    _load_depth_weight(port.depth_weight, variables)
    got = port(*to_torch(feats, ref_proj, src_projs, hyp))
    assert got.shape == ref.shape == (1, d, h, w, g)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_depth_weight_folded_matches_unfolded():
    """The eval-BN fold the kernel takes == DepthWeight's own evaluation."""
    rng = np.random.RandomState(13)
    g = 8
    dw = DepthWeight(g).requires_grad_(False)
    with torch.no_grad():
        dw[0].conv.weight.copy_(torch.from_numpy(
            rng.randn(1, g, 1, 1, 1).astype(np.float32)))
        dw[0].bn.weight.fill_(1.3)
        dw[0].bn.bias.fill_(-0.2)
        dw[0].bn.running_mean.fill_(0.4)
        dw[0].bn.running_var.fill_(0.7)
        dw[1].weight.fill_(0.8)
        dw[1].bias.fill_(0.1)
    sim = torch.from_numpy(rng.rand(2, 3, 5, 7, g).astype(np.float32))
    torch.testing.assert_close(depth_weight_folded(sim, *dw.fold()), dw(sim),
                               atol=1e-6, rtol=1e-6)


def test_cpu_wrapper_takes_plain_version():
    """A CPU tensor goes to the plain version (no build, no launch)."""
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel
    rng = np.random.RandomState(14)
    feats, ref_proj, src_projs = _scene(rng, 3, 8, 16, 8)
    diffs = feats[..., 0::2] - feats[..., 1::2]
    hyp = _hypos(rng, 3, 8, 16, False)
    args = to_torch(diffs[:, 1:], diffs[:, 0], src_projs, ref_proj, hyp,
                    rng.randn(4).astype(np.float32))
    scalars = [torch.tensor(s) for s in (1.0, 0.0, 1.0, 0.0)]
    before = dict(aggregate_kernel.LAUNCHES)
    torch.testing.assert_close(rowsweep_aggregate(*args, *scalars),
                               rowsweep_aggregate_plain(*args, *scalars))
    assert aggregate_kernel.LAUNCHES == before


def _plan_voxels(plan, b, d, h, w):
    """The flat (b, d, h, w) index of every voxel that K1's lane groups
    store under ``plan``, one entry per store, by the kernel's own
    decomposition (csrc/rowsweep_aggregate.cu): block i covers pixel tile
    i % tiles, plane run (i / tiles) % runs and item i / (tiles * runs);
    its group j the pixel tile * pixels + j (stored if < H W) and planes
    run * planes .. (< D)."""
    hw = h * w
    tiles, runs = -(-hw // plan.pixels), -(-d // plan.planes)
    blk = np.arange(plan.blocks)[:, None, None]
    grp = np.arange(plan.pixels)[None, :, None]
    j = np.arange(plan.planes)[None, None, :]
    pix = blk % tiles * plan.pixels + grp
    plane = blk // tiles % runs * plan.planes + j
    item = blk // tiles // runs
    live = np.broadcast_to((pix < hw) & (plane < d) & (item < b),
                           (plan.blocks, plan.pixels, plan.planes))
    flat = (item * d + plane) * hw + pix
    return np.broadcast_to(flat, live.shape)[live]


@pytest.mark.parametrize("b,d,h,w,g", [
    (1, 48, 148, 200, 32), (1, 24, 296, 400, 16), (1, 8, 592, 800, 8),
    (4, 48, 64, 80, 32), (2, 11, 13, 37, 8), (2, 11, 13, 37, 16),
    (2, 11, 13, 37, 32), (1, 3, 1, 5, 32)])
def test_aggregate_plan_covers_every_voxel_once(b, d, h, w, g):
    """K1's launch plan (csrc/rowsweep_aggregate.cu) at the DTU eval stage
    shapes, DTU train stage 0 and extents its pixel tiles and plane runs do
    not divide: G / 8 lanes a pixel, 128 threads a block, and every (b, d,
    h, w) stored by exactly one lane group."""
    from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import aggregate_plan
    plan = aggregate_plan(b, d, h, w, g)
    assert plan.lanes * 8 == g and plan.lanes * plan.pixels == 128
    assert plan.planes == min(d, 8)
    flat = _plan_voxels(plan, b, d, h, w)
    counts = np.bincount(flat, minlength=b * d * h * w)
    assert counts.shape == (b * d * h * w,) and (counts == 1).all()

