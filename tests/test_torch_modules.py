"""The port's modules and ops vs their JAX counterparts at small widths, f32,
on the same inputs (numpy seeds) and the same weights."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_helpers import SMALL, jax_model_and_port, scene_args, to_torch
from mdfnet_tpu import geometry as jgeo
from mdfnet_tpu.models.backbone import FPN4Scales as JaxFPN
from mdfnet_tpu.models.refine import RefineNet2 as JaxRefine
from mdfnet_tpu.models.regularize import (RegularNet3Scales as JaxReg3,
                                          RegularNet4Scales as JaxReg4)
from mdfnet_tpu.ops import fitting as jfit
from mdfnet_tpu.ops import regress as jreg
from mdfnet_tpu.ops import sample as jsample
from mdfnet_tpu.ops.warp import homography_warp as jax_warp
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops import fitting, regress, sample
from mdfnet_tpu_torch.ops.warp import homography_warp

# f32 on both sides; XLA and ATen accumulate convolutions and reductions in
# different orders, which moves O(1) activations by ~1e-6
ATOL, RTOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def small():
    """JAX CoreNet (SMALL widths) variables and the port loaded from them."""
    _, variables, port = jax_model_and_port(SMALL, scene_args(64, 96, 3))
    return variables, port


def _sub(variables, name):
    out = {"params": variables["params"][name]}
    if name in variables["batch_stats"]:
        out["batch_stats"] = variables["batch_stats"][name]
    return out


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def test_fpn4scales(small):
    variables, port = small
    x = np.random.RandomState(1).rand(3, 64, 96, 3).astype(np.float32)
    ref = JaxFPN(SMALL.chs).apply(_sub(variables, "backbone"),
                                  jnp.asarray(x), False)
    got = port.Backbone(*to_torch(x))
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        _close(g.numpy(), r)


@pytest.mark.parametrize("stage,depth", [(0, 8), (1, 8), (2, 8)])
def test_regularnets(small, stage, depth):
    variables, port = small
    g = SMALL.ngroups[stage]
    vol = np.random.RandomState(stage).rand(1, depth, 16, 24, g) \
        .astype(np.float32)
    net = JaxReg3(16) if stage == 0 else JaxReg4(8)
    ref = net.apply(_sub(variables, f"regular{stage}"), jnp.asarray(vol),
                    False)
    got = port.Regular[stage](*to_torch(vol))
    assert got.shape == ref.shape == (1, depth, 16, 24)
    _close(got.numpy(), ref, atol=1e-5)    # probabilities


def test_refinenet2(small):
    variables, port = small
    rng = np.random.RandomState(3)
    depth = rng.uniform(500.0, 800.0, (1, 16, 24)).astype(np.float32)
    drange = np.array([[425.0, 935.0]], np.float32)
    ref = JaxRefine().apply(_sub(variables, "refine"), jnp.asarray(depth),
                            jnp.asarray(drange), False)
    got = port.Refine(*to_torch(depth, drange))
    assert got.shape == ref.shape == (1, 32, 48)
    # depths ~500-900: 1e-3 is ~1e-6 relative, f32 summation order
    _close(got.numpy(), ref, atol=1e-3, rtol=0)


# ------------------------------------------------------------------ ops

def _cameras(stage=2):
    args = scene_args(32, 48, nviews=3, structure="plane")
    intr, extr = args[2].astype(np.float32), args[1].astype(np.float32)
    return intr, extr


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_projection_matrices(stage):
    intr, extr = _cameras()
    ref = jgeo.projection_matrices(jnp.asarray(intr), jnp.asarray(extr),
                                   stage)
    got = geometry.projection_matrices(*to_torch(intr, extr), stage)
    for r, g in zip(ref, got):
        _close(g.numpy(), r, atol=1e-3, rtol=1e-6)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_sweep_coordinates(per_pixel):
    intr, extr = _cameras()
    rp, sp = jgeo.projection_matrices(jnp.asarray(intr), jnp.asarray(extr),
                                      3)
    h, w = 32, 48
    rng = np.random.RandomState(4)
    hyp = (rng.uniform(450, 900, (1, 6, h, w)) if per_pixel
           else np.linspace(450, 900, 6).reshape(1, 6, 1, 1)) \
        .astype(np.float32)
    ref = jgeo.reference_grid_coords(
        *jgeo.sweep_coordinates(sp[:, 0], rp, jnp.asarray(hyp), h, w), h, w)
    got = geometry.reference_grid_coords(
        *geometry.sweep_coordinates(*to_torch(np.asarray(sp[:, 0]),
                                              np.asarray(rp), hyp), h, w),
        h, w)
    for r, g in zip(ref, got):
        # pixel coordinates up to ~50: f32 rounding of the 4x4 inverse
        _close(g.numpy(), r, atol=1e-3, rtol=1e-5)


def test_bilinear_sample_zero_padding():
    rng = np.random.RandomState(5)
    img = rng.randn(2, 7, 9, 4).astype(np.float32)
    # inside, on the borders, just outside, far outside, and exactly -1 / W
    x = rng.uniform(-3.0, 11.0, (2, 5, 60)).astype(np.float32)
    y = rng.uniform(-3.0, 9.0, (2, 5, 60)).astype(np.float32)
    x[:, 0, :4] = [-1.0, 9.0, -0.5, 8.5]
    y[:, 0, :4] = [0.0, 6.0, -1.0, 7.0]
    ref = jsample.bilinear_sample_2d(*map(jnp.asarray, (img, x, y)))
    got = sample.bilinear_sample_2d(*to_torch(img, x, y))
    assert got.shape == ref.shape == (2, 5, 60, 4)
    _close(got.numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fn", ["resize_bilinear_2x", "resize_nearest_2x"])
def test_resize(fn):
    x = np.random.RandomState(6).randn(2, 3, 5, 7).astype(np.float32)
    ref = getattr(jsample, fn)(jnp.asarray(x))
    got = getattr(sample, fn)(*to_torch(x))
    assert got.shape == ref.shape == (2, 3, 10, 14)
    _close(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_homography_warp():
    intr, extr = _cameras()
    rp, sp = jgeo.projection_matrices(jnp.asarray(intr), jnp.asarray(extr),
                                      3)
    rng = np.random.RandomState(7)
    feat = rng.randn(1, 32, 48, 6).astype(np.float32)
    hyp = rng.uniform(450, 900, (1, 4, 32, 48)).astype(np.float32)
    ref = jax_warp(jnp.asarray(feat), sp[:, 1], rp, jnp.asarray(hyp))
    got = homography_warp(*to_torch(feat, np.asarray(sp[:, 1]),
                                    np.asarray(rp), hyp))
    assert got.shape == ref.shape == (1, 4, 32, 48, 6)
    # coordinates carry ~1e-5 px of f32 rounding; features are O(1)
    _close(got.numpy(), ref, atol=1e-3, rtol=1e-4)


def _prob_volume(rng, d=12, h=6, w=8):
    logits = rng.randn(1, d, h, w).astype(np.float32) * 3.0
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _peaked(rng, d=12, h=6, w=8):
    """A posterior that is a noisy Gaussian over sorted hypotheses, as a
    trained cost volume gives, and the hypotheses."""
    hyp = np.sort(rng.uniform(450, 900, (1, d, h, w)), axis=1)
    mu = rng.uniform(500, 850, (1, 1, h, w))
    sig = rng.uniform(80, 200, (1, 1, h, w))
    logp = -(hyp - mu) ** 2 / (2 * sig ** 2) + rng.randn(1, d, h, w) * 0.05
    p = np.exp(logp - logp.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)).astype(np.float32), \
        hyp.astype(np.float32)


def test_depth_and_confidence_regression():
    rng = np.random.RandomState(8)
    prob = _prob_volume(rng)
    hyp = np.sort(rng.uniform(450, 900, (1, 12, 6, 8)), axis=1) \
        .astype(np.float32)
    _close(regress.depth_regression(*to_torch(prob, hyp)).numpy(),
           jreg.depth_regression(jnp.asarray(prob), jnp.asarray(hyp)),
           atol=1e-3, rtol=1e-6)
    _close(regress.confidence_regression(*to_torch(prob)).numpy(),
           jreg.confidence_regression(jnp.asarray(prob)), atol=1e-6)


# gauss1 solves its 3x3 normal equations by Cramer's rule on sums of x^4
# (~1e11) that cancel: in f32 a different summation order moves the width by
# up to ~0.5% (measured 4.8e-3); the laplace ratio is well conditioned
@pytest.mark.parametrize("fitter,rtol", [("fit_gauss1", 1e-2),
                                         ("fit_laplace", 1e-5)])
def test_curve_fits(fitter, rtol):
    prob, hyp = _peaked(np.random.RandomState(9))
    depth = (prob * hyp).sum(1)
    ref = getattr(jfit, fitter)(*map(jnp.asarray, (depth, prob, hyp)))
    got = getattr(fitting, fitter)(*to_torch(depth, prob, hyp))
    _close(got.numpy(), ref, atol=0, rtol=rtol)


@pytest.mark.parametrize("curve,thresh,nd", [("gauss1", 0.95, 24),
                                             ("laplace", 1e-5, 8)])
def test_refined_hypotheses(curve, thresh, nd):
    rng = np.random.RandomState(10)
    prob = _prob_volume(rng, d=16)
    hyp = np.broadcast_to(np.linspace(425, 935, 16).reshape(1, 16, 1, 1),
                          (1, 16, 6, 8)).astype(np.float32)
    depth = (prob * hyp).sum(1)
    drange = np.array([[425.0, 935.0]], np.float32)
    kw = dict(ndepths=nd, curve_class=curve, prob_thresh=thresh)
    ref = jfit.refined_hypotheses(*map(jnp.asarray, (depth, drange, prob,
                                                     hyp)), **kw)
    got = fitting.refined_hypotheses(*to_torch(depth, drange, prob, hyp),
                                     **kw)
    assert got.shape == ref.shape == (1, nd, 12, 16)
    # depths ~425-935 and radii from the fits above (rtol 2e-3 of a radius
    # <= 102 = 20% of the range): well inside 0.5 depth units
    _close(got.numpy(), ref, atol=0.5, rtol=0)


def test_uniform_hypotheses():
    drange = np.array([[425.0, 935.0], [400.0, 1000.0]], np.float32)
    _close(fitting.uniform_hypotheses(*to_torch(drange), 48).numpy(),
           jfit.uniform_hypotheses(jnp.asarray(drange), 48), atol=1e-4)
