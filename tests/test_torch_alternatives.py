"""The alternative units (``ModelConfig.aggregate_impl="variance"``,
``hypo_impl="atv"``, ``refine_impl="refine1"``, ``gauss0`` curves) in the
port vs the JAX package on its exact f32 XLA path (``warp_impl="gather"``):
function-level twins, each config's eval forward, parameter count and
weights, on the CPU (``tests/test_torch_alternatives_train.py``: the train
steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (ALTERNATIVES, alternative, build_port,
                                 depth_error, jax_model_and_port,
                                 scene_args, to_torch)
from mdfnet_tpu import geometry as jgeo
from mdfnet_tpu.models.aggregate_variance import \
    VarianceAggregate as JaxVariance
from mdfnet_tpu.models.refine import RefineNet as JaxRefine
from mdfnet_tpu.ops import fitting as jfit
from mdfnet_tpu.ops import regress as jreg
from mdfnet_tpu.ops import sample as jsample
from mdfnet_tpu.utils.pth_import import variables_to_state_dict
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.models.aggregate_variance import VarianceAggregate
from mdfnet_tpu_torch.models.registry import count_params
from mdfnet_tpu_torch.ops import fitting, regress, sample
from mdfnet_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                            state_dict_from_jax_variables)

# the ProbConvs' weights are scaled by this in the parity forwards, so that
# the posteriors have peaks (seeded weights give flat ones, on which the
# hypotheses hardly depend)
PROB_GAIN = 30.0


def _sharpened(variables):
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for s in range(3):
        params[f"regular{s}"]["prob"]["kernel"] *= PROB_GAIN
    return {**variables, "params": params}


# ------------------------------------------------------------ functions

@pytest.fixture(scope="module")
def posterior():
    """A peaked (B, D, H, W) posterior with per-pixel hypotheses and its
    regressed depth."""
    rng = np.random.RandomState(0)
    d, h, w = 8, 12, 16
    hypos = (500.0 + np.arange(d)[None, :, None, None] * 6.0
             + rng.uniform(0, 20, (2, 1, h, w))).astype(np.float32)
    logits = rng.randn(2, d, h, w).astype(np.float32) * 3.0
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    depth = (prob * hypos).sum(1).astype(np.float32)
    return prob.astype(np.float32), hypos, depth


def test_fit_gauss0(posterior):
    prob, hypos, depth = posterior
    ref = jfit.fit_gauss0(jnp.asarray(depth), jnp.asarray(prob),
                          jnp.asarray(hypos))
    got = fitting.fit_gauss0(*to_torch(depth, prob, hypos))
    # f32 sums of squared offsets in other orders; the width is a ratio
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4)


@pytest.mark.parametrize("nd", [8, 24])
def test_atv_hypos(posterior, nd):
    prob, hypos, depth = posterior
    rng = np.random.RandomState(1)
    fine = rng.uniform(500.0, 560.0, (2, 24, 32)).astype(np.float32)
    dev = np.sqrt(np.maximum(
        (prob * (hypos - depth[:, None]) ** 2).sum(1), 0)).astype(np.float32)
    drange = np.array([[425.0, 935.0], [430.0, 900.0]], np.float32)
    ref = jfit.atv_hypos(jnp.asarray(fine), jnp.asarray(dev),
                         jnp.asarray(drange), nd)
    got = fitting.atv_hypos(*to_torch(fine, dev, drange), nd)
    assert got.shape == ref.shape == (2, nd, 24, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    stage0 = fitting.atv_hypos(None, None, torch.from_numpy(drange), nd)
    torch.testing.assert_close(stage0, fitting.uniform_hypotheses(
        torch.from_numpy(drange), nd), rtol=0, atol=0)


@pytest.mark.parametrize("thresh", [0.95, 1e-5])
def test_refined_hypotheses_gauss0(posterior, thresh):
    prob, hypos, depth = posterior
    drange = np.array([[425.0, 935.0], [430.0, 900.0]], np.float32)
    ref = jfit.refined_hypotheses(
        jnp.asarray(depth), jnp.asarray(drange), jnp.asarray(prob),
        jnp.asarray(hypos), ndepths=8, curve_class="gauss0",
        prob_thresh=thresh)
    got = fitting.refined_hypotheses(
        *to_torch(depth, drange, prob, hypos), ndepths=8,
        curve_class="gauss0", prob_thresh=thresh)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("fn", ["resize_bilinear_2x_align_corners",
                                "resize_bicubic_2x"])
@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 3, 9, 4), (2, 2)])
def test_resizes(fn, shape):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    ref = getattr(jsample, fn)(jnp.asarray(x))
    got = getattr(sample, fn)(*to_torch(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 1, 6), (2, 4, 1)])
def test_resize_align_corners_of_one_row(shape):
    """An axis of length 1 repeats its row, through the general formula;
    the other axis as JAX's (atol 1e-6)."""
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    got = sample.resize_bilinear_2x_align_corners(*to_torch(x))
    ref = jsample.resize_bilinear_2x_align_corners(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    axis = shape.index(1)
    np.testing.assert_array_equal(got.narrow(axis, 0, 1).numpy(),
                                  got.narrow(axis, 1, 1).numpy())


def test_resize_align_corners_keeps_the_corners():
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 6, 5)
                         .astype(np.float32))
    y = sample.resize_bilinear_2x_align_corners(x)
    for i, j in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        torch.testing.assert_close(y[:, i, j], x[:, i, j])


def test_confidence_ema(posterior):
    prob, _, _ = posterior
    last = np.random.RandomState(5).rand(2, 6, 8).astype(np.float32)
    ref = jreg.confidence_regression(jnp.asarray(prob),
                                     last_confidence=jnp.asarray(last))
    got = regress.confidence_regression(*to_torch(prob, last))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    plain = regress.confidence_regression(*to_torch(prob))
    assert not torch.allclose(got, plain)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_variance_aggregate(per_pixel):
    """Against JAX's VarianceAggregate on its gather warp."""
    args = scene_args(32, 48, nviews=3, structure="plane")
    intr, extr = args[2].astype(np.float32), args[1].astype(np.float32)
    ref_proj, src_projs = jgeo.projection_matrices(
        jnp.asarray(intr), jnp.asarray(extr), 2, num_stages=4)
    rng = np.random.RandomState(6)
    h, w, c, d = 16, 24, 16, 6
    feats = rng.randn(1, 3, h, w, c).astype(np.float32)
    hypos = (np.linspace(500, 800, d)[None, :, None, None]
             + (rng.uniform(0, 30, (1, 1, h, w)) if per_pixel else 0)
             ).astype(np.float32)
    ref = JaxVariance(warp_impl="gather").apply(
        {}, [jnp.asarray(feats[:, v]) for v in range(3)], ref_proj,
        src_projs, jnp.asarray(hypos))
    p_ref, p_src = geometry.projection_matrices(
        *to_torch(intr, extr), 2, num_stages=4)
    got = VarianceAggregate()(torch.from_numpy(feats), p_ref, p_src,
                              torch.from_numpy(hypos))
    assert got.shape == ref.shape == (1, d, h, w, c)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", params=list(ALTERNATIVES))
def jax_and_port(request):
    """(config name, JAX CoreNet on the exact f32 XLA path, its variables,
    the port loaded with them) for each alternative config, SMALL widths."""
    name = request.param
    args = scene_args(64, 96, nviews=3, structure="steps")
    return (name,) + jax_model_and_port(alternative(name), args)


@pytest.mark.parametrize("jax_and_port", ["refine1"], indirect=True)
def test_refinenet_v1(jax_and_port):
    _, _, variables, port = jax_and_port
    rng = np.random.RandomState(7)
    img = rng.rand(1, 32, 48, 3).astype(np.float32)
    depth = rng.uniform(500.0, 800.0, (1, 16, 24)).astype(np.float32)
    drange = np.array([[425.0, 935.0]], np.float32)
    sub = {"params": variables["params"]["refine"],
           "batch_stats": variables["batch_stats"]["refine"]}
    ref = JaxRefine().apply(sub, jnp.asarray(img), jnp.asarray(depth),
                            jnp.asarray(drange), False)
    got = port.Refine(*to_torch(img, depth, drange))
    assert got.shape == ref.shape == (1, 32, 48)
    # depths ~500-900: 1e-3 is ~1e-6 relative, f32 summation order
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


# ------------------------------------------------------------ whole model

def test_alternative_forward_matches_jax(jax_and_port):
    """The eval forward at SMALL widths (C == 2G) on a 64x96 scene with
    depth steps, 3 views, ProbConvs sharpened, under the bounds of
    test_torch_core.py::test_corenet_matches_jax."""
    name, jm, variables, _ = jax_and_port
    args = scene_args(64, 96, nviews=3, structure="steps")
    variables = _sharpened(variables)
    port = build_port(alternative(name))
    port.load_state_dict(state_dict_from_jax_variables(variables),
                         strict=True)
    ref = {k: np.asarray(v) for k, v in jax.jit(
        lambda *a: jm.apply(variables, *a, train=False))(*args).items()}
    out = port(*to_torch(*args))
    assert out["depth"].shape == (1, 64, 96)
    err = depth_error(out["depth"].numpy(), ref["depth"])
    assert np.median(err) <= 1e-5 and err.max() <= 1e-3, \
        (np.median(err), err.max())
    np.testing.assert_allclose(out["confidence"].numpy(), ref["confidence"],
                               atol=1e-4)


def test_alternative_params_and_weights(jax_and_port):
    """count_params equals the JAX tree's; the JAX variables -> state_dict
    -> load_state_dict(strict=True) round trip keeps every array; the
    default units' entries are pth_import's."""
    name, _, variables, port = jax_and_port
    n_jax = sum(np.asarray(v).size
                for v in jax.tree_util.tree_leaves(variables["params"]))
    assert count_params(port) == n_jax
    sd = jax_variables_to_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    if name in ("atv", "gauss0"):     # the default units' variable tree
        want = variables_to_state_dict(variables)
        assert set(want) == set(sd)
        for k, v in want.items():
            np.testing.assert_array_equal(sd[k], v, err_msg=k)



@pytest.mark.parametrize("missing", ["refine", "regular0/prob",
                                     "backbone/conv01_0/bn"])
def test_weights_refuse_a_partial_tree(jax_and_port, missing):
    """A tree without one of its units' modules or variables raises
    KeyError instead of giving a partial state_dict."""
    name, _, variables, _ = jax_and_port
    *parents, leaf = missing.split("/")

    def without(tree):
        tree = dict(tree)
        node = tree
        for k in parents:
            node[k] = dict(node[k])
            node = node[k]
        node.pop(leaf, None)
        return tree
    with pytest.raises(KeyError):
        jax_variables_to_state_dict({
            "params": without(variables["params"]),
            "batch_stats": without(variables["batch_stats"])})

# ------------------------------------------------- the card's forward gate

@pytest.mark.parametrize("name", ["default"] + list(ALTERNATIVES))
def test_forward_bounds_hold_bf16_rounding(name):
    """chip_smoke.py holds each config's bf16 kernel forward to the plain
    f32 forward under FORWARD_BOUNDS and the depth bounds. Those bounds
    must leave room for bf16 rounding alone: the plain versions in bf16
    against f32 at 128x160 x 5 views (the gate's seeded weights, sharpened
    as it does) read within each bound. Prints the readings (-s)."""
    import chip_smoke as cs
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.data import make_batch, make_plane_scene
    from mdfnet_tpu_torch.models.registry import build_model
    height, width = 128, 160
    scene = make_plane_scene(height=height, width=width, nviews=5,
                             tilt=0.05, focal=1.8 * width)
    batch = make_batch(scene, batch=1)
    args = [torch.from_numpy(batch[k])
            for k in ("imgs", "extrinsics", "intrinsics", "depth_range")]
    fields = ALTERNATIVES.get(name, {})
    m32 = build_model(ModelConfig(**fields), seed=0, device="cpu")
    cs.sharpen(m32)
    m16 = build_model(ModelConfig(**fields), compute_dtype="bfloat16",
                      seed=0, device="cpu")
    m16.load_state_dict(m32.state_dict())
    with torch.no_grad():
        out, vols = cs.stage_volumes(m16, args, plain=True)
        ref, ref_vols = cs.stage_volumes(m32, args, plain=True)
    err = ((out["depth"].float() - ref["depth"]).abs()
           / (cs.DEPTH_RANGE[1] - cs.DEPTH_RANGE[0])).flatten().numpy()
    got = {"confidence mean |diff|": (out["confidence"].float()
                                      - ref["confidence"]).abs().mean()
           .item()}
    for key, r in ref_vols.items():
        d = (vols[key] - r).abs().mean().item()
        got[key] = d / r.std().item() if key.startswith("cost") else d
    bounds = dict(cs.FORWARD_BOUNDS, **{"depth median": cs.MEDIAN_BOUND,
                                        "depth p95": cs.P95_BOUND})
    got["depth median"] = float(np.median(err))
    got["depth p95"] = float(np.percentile(err, 95))
    print(name, {k: f"{v:.2e} ({v / bounds[k]:.2f} of the bound)"
                 for k, v in got.items()})
    assert set(got) == set(bounds)
    for k, v in got.items():
        assert v <= bounds[k], (k, v, bounds[k])
