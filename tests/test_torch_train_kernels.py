"""The training step's kernels (K6 sample, K7 splat, K8 conv backward):
their plain PyTorch versions vs the TPU kernels in Pallas interpret mode,
the JAX package's XLA formulations, and autodiff of the JAX gather warp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import to_torch
from mdfnet_tpu import geometry as jgeo
from mdfnet_tpu.data.synthetic import make_plane_scene
from mdfnet_tpu.ops.pallas.conv2d_vjp import conv2d_train as jax_conv2d_train
from mdfnet_tpu.ops.pallas.conv3d_vjp import (conv3d_train as jax_conv3d_train,
                                              trconv3d_train as
                                              jax_trconv3d_train)
from mdfnet_tpu.ops.pallas.splat_kernel import pallas_splat_2d
from mdfnet_tpu.ops.pallas.warp_kernel import pallas_sample_2d_multi
from mdfnet_tpu.ops.splat import dense_splat_2d
from mdfnet_tpu.ops.warp import homography_warp as jax_gather_warp
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.ops.cuda import conv_kernel, splat_kernel, warp_kernel
from mdfnet_tpu_torch.ops.cuda.conv_vjp import (conv2d_train, conv3d_train,
                                                trconv3d_train)
from mdfnet_tpu_torch.ops.cuda.splat_kernel import splat_2d
from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d
from mdfnet_tpu_torch.ops.warp import homography_warp, homography_warp_train

# f32 on both sides; only summation order differs
ATOL = 1e-4


def _cameras(h, w, v, yaw=0.0):
    """(ref_proj (1, 4, 4), src_projs (1, v-1, 4, 4)) as numpy: cameras
    along x at an MVS focal; ``yaw`` turns view i by i * yaw about y."""
    k = np.array([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]],
                 np.float32)
    e = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    e[:, 0, 3] = -np.arange(v) * 12.0
    for i in range(v):
        c, s = np.cos(i * yaw), np.sin(i * yaw)
        e[i, 0, 0], e[i, 0, 2], e[i, 2, 0], e[i, 2, 2] = c, s, -s, c
    ref, src = jgeo.projection_matrices(jnp.asarray(np.tile(k, (1, v, 1, 1))),
                                        jnp.asarray(e[None]), stage=3)
    return np.asarray(ref), np.asarray(src)


def _coords(src_proj, ref_proj, hyp, h, w):
    """The warp's (B, D, H, W) sample coordinates, from the port's geometry
    (the same f32 arithmetic as the JAX package's)."""
    x, y = geometry.sweep_coordinates(*to_torch(src_proj, ref_proj, hyp),
                                      h, w)
    x, y = geometry.reference_grid_coords(x, y, h, w)
    b, d = hyp.shape[:2]
    return x.reshape(b, d, h, w), y.reshape(b, d, h, w)


def _plane_setup(rng, h=24, w=40, d=5, c=8, b=2):
    """A tilted-plane scene with per-pixel planes; the TPU splat's and the
    XLA splat's row-band / x-window contracts hold there."""
    scene = make_plane_scene(height=h, width=w, nviews=2, plane_depth=600.0,
                             tilt=0.05)
    intr = np.repeat(scene.intrinsics[None], b, 0)
    extr = np.repeat(scene.extrinsics[None], b, 0)
    rp, sp = jgeo.projection_matrices(jnp.asarray(intr), jnp.asarray(extr), 2)
    hyp = (np.linspace(520, 680, d, dtype=np.float32)[None, :, None, None]
           + rng.rand(b, d, h, w).astype(np.float32) * 5.0)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    return feat, np.asarray(sp[:, 0]), np.asarray(rp), hyp


# ------------------------------------------------------------------ K6


def test_sample_plain_matches_pallas_and_gather():
    rng = np.random.RandomState(0)
    h, w, d, c = 24, 40, 5, 8
    feat, sp, rp, hyp = _plane_setup(rng, h, w, d, c)
    x, y = _coords(sp, rp, hyp, h, w)
    got = sample_2d(torch.from_numpy(feat), x.reshape(2, d * h, w),
                    y.reshape(2, d * h, w)).numpy()
    # (the TPU kernel's coverage flag is False here: the last row's lower
    # tap lies below the image, outside its window, where it reads zero
    # anyway; the samples agree all the same)
    pallas, _ = pallas_sample_2d_multi(
        jnp.asarray(feat), jnp.asarray(x.numpy()).reshape(2, d * h, w),
        jnp.asarray(y.numpy()).reshape(2, d * h, w), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
    want = np.stack([np.asarray(jax_gather_warp(
        jnp.asarray(feat[i:i + 1]), jnp.asarray(sp[i:i + 1]),
        jnp.asarray(rp[i:i + 1]), jnp.asarray(hyp[i:i + 1])))[0]
        for i in range(2)])
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=ATOL)


def test_sample_bf16_rounds_once_from_f32():
    """The plain version computes in f32 and rounds once to the image's
    dtype, as the kernel does."""
    rng = np.random.RandomState(1)
    img = torch.from_numpy(rng.randn(2, 6, 9, 8).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-2, 10, (2, 3, 7)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, 7, (2, 3, 7)).astype(np.float32))
    b16 = img.to(torch.bfloat16)
    got = sample_2d(b16, x, y)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 7, 8)
    torch.testing.assert_close(got, sample_2d(b16.float(), x, y)
                               .to(torch.bfloat16), rtol=0, atol=0)


def test_warp_train_matches_gather_warp():
    """The training warp's forward == the gather warp of each source."""
    rng = np.random.RandomState(2)
    h, w, d, c, v = 16, 24, 4, 8, 3
    ref, src = _cameras(h, w, v)
    feats = torch.from_numpy(rng.randn(1, v - 1, h, w, c).astype(np.float32))
    hyp = torch.linspace(425, 935, d).reshape(1, d, 1, 1)
    got = homography_warp_train(feats, torch.from_numpy(src),
                                torch.from_numpy(ref), hyp)
    assert got.shape == (1, v - 1, d, h, w, c)
    for s in range(v - 1):
        want = homography_warp(feats[:, s], torch.from_numpy(src[:, s]),
                               torch.from_numpy(ref), hyp)
        torch.testing.assert_close(got[:, s], want, rtol=0, atol=ATOL)


# ------------------------------------------------------------------ K7


def test_splat_plain_matches_pallas_and_dense():
    rng = np.random.RandomState(3)
    h, w, d, c = 24, 40, 5, 8
    _, sp, rp, hyp = _plane_setup(rng, h, w, d, c)
    x, y = _coords(sp, rp, hyp, h, w)
    g = rng.randn(2, d, h, w, c).astype(np.float32)
    got = splat_2d(torch.from_numpy(g), x, y, h, w).numpy()
    assert got.dtype == np.float32 and got.shape == (2, h, w, c)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    pallas, cover = pallas_splat_2d(jnp.asarray(g), jx, jy, h, w, band=8,
                                    x_margin=16, interpret=True)
    assert bool(cover)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
    dense, cover = dense_splat_2d(jnp.asarray(g), jx, jy, h, w, x_tile=16,
                                  x_margin=8, band=8)
    assert bool(cover)
    np.testing.assert_allclose(got, np.asarray(dense), atol=ATOL)


@pytest.mark.parametrize("yaw", [0.0, 0.35])
def test_warp_train_grad_matches_jax_gather_autodiff(yaw):
    """The training warp's backward (the splat) == autodiff of the JAX
    gather warp. ``yaw`` 0.35 rad (20 degrees between views, planes from 40
    to 5000) is a camera where the JAX splat's row-band / x-window contract
    does not hold; the port's splat has no contract."""
    rng = np.random.RandomState(4)
    h, w, d, c, v = 16, 24, 6, 8, 3
    ref, src = _cameras(h, w, v, yaw)
    hyp = np.linspace(*((40, 5000) if yaw else (425, 935)), d,
                      dtype=np.float32).reshape(1, d, 1, 1)
    feats = rng.randn(1, v - 1, h, w, c).astype(np.float32)
    g = rng.randn(1, v - 1, d, h, w, c).astype(np.float32)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = homography_warp_train(f, *to_torch(src, ref, hyp))
    (out * torch.from_numpy(g)).sum().backward()
    for s in range(v - 1):
        _, vjp = jax.vjp(lambda t: jax_gather_warp(
            t, jnp.asarray(src[:, s]), jnp.asarray(ref), jnp.asarray(hyp)),
            jnp.asarray(feats[:, s]))
        want, = vjp(jnp.asarray(g[:, s]))
        np.testing.assert_allclose(f.grad[:, s].numpy(), np.asarray(want),
                                   atol=ATOL)
    # with its windows scaled to this small image (2-row bands, 8-px
    # tiles, 1-px margins), the JAX splat's contract fails at this camera
    x, y = _coords(src[:, 0], ref, hyp, h, w)
    _, cover = dense_splat_2d(jnp.asarray(g[:, 0]), jnp.asarray(x.numpy()),
                              jnp.asarray(y.numpy()), h, w, x_tile=8,
                              x_margin=1, band=2)
    assert bool(cover) == (not yaw)


def test_cpu_kernels_launch_nothing():
    """CPU tensors take the plain versions: no build, counters unchanged."""
    before = (dict(warp_kernel.LAUNCHES), dict(splat_kernel.LAUNCHES),
              dict(conv_kernel.LAUNCHES))
    img = torch.randn(1, 4, 5, 8)
    x, y = torch.rand(1, 2, 3) * 4, torch.rand(1, 2, 3) * 3
    sample_2d(img, x, y)
    splat_2d(torch.randn(1, 1, 2, 3, 8), x[:, None], y[:, None], 4, 5)
    xt = torch.randn(1, 4, 4, 4, 8, requires_grad=True)
    conv3d_train(xt, torch.randn(8, 8, 3, 3, 3)).sum().backward()
    assert (dict(warp_kernel.LAUNCHES), dict(splat_kernel.LAUNCHES),
            dict(conv_kernel.LAUNCHES)) == before


# ------------------------------------------------------------------ K8


def _port_grads(fn, x, k_torch, ct):
    """Output, d_input and d_weight of ``fn`` (channels-last port layout)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(k_torch).requires_grad_(True)
    y = fn(xt, wt)
    (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _dhcw(a):   # (B, D, H, W, C) <-> (B, D, H, C, W)
    return np.ascontiguousarray(np.swapaxes(a, -1, -2))


@pytest.mark.parametrize("stride,shape", [(1, (2, 5, 6, 8, 4)),
                                          (2, (2, 6, 8, 4, 16)),
                                          (2, (1, 5, 7, 9, 8)),   # odd D/H/W
                                          (1, (1, 4, 5, 6, 8))])
def test_conv3d_train_matches_jax_vjp(stride, shape):
    rng = np.random.RandomState(10 + stride)
    b, d, h, w, ci = shape
    co = 6
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)
    ct = rng.randn(b, -(-d // stride), -(-h // stride), -(-w // stride),
                   co).astype(np.float32)
    y, dx, dw = _port_grads(lambda a, k_: conv3d_train(a, k_, stride), x,
                            np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)),
                            ct)
    y_j, vjp = jax.vjp(lambda a, k_: jax_conv3d_train(a, k_, stride, True),
                       jnp.asarray(_dhcw(x)), jnp.asarray(k))
    dx_j, dk_j = vjp(jnp.asarray(_dhcw(ct)))
    np.testing.assert_allclose(y, _dhcw(np.asarray(y_j)), atol=ATOL)
    np.testing.assert_allclose(dx, _dhcw(np.asarray(dx_j)), atol=ATOL)
    np.testing.assert_allclose(dw, np.asarray(dk_j).transpose(4, 3, 0, 1, 2),
                               atol=ATOL)


@pytest.mark.parametrize("shape,co", [((2, 3, 4, 8, 4), 5),
                                      ((1, 4, 5, 9, 8), 1)])  # odd; Co=1
def test_trconv3d_train_matches_jax_vjp(shape, co):
    rng = np.random.RandomState(20 + co)
    b, d, h, w, ci = shape
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, co, ci) * 0.1).astype(np.float32)  # (*k, O, I)
    ct = rng.randn(b, 2 * d, 2 * h, 2 * w, co).astype(np.float32)
    y, dx, dw = _port_grads(trconv3d_train, x,
                            np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)),
                            ct)
    y_j, vjp = jax.vjp(lambda a, k_: jax_trconv3d_train(a, k_, True),
                       jnp.asarray(_dhcw(x)), jnp.asarray(k))
    dx_j, dk_j = vjp(jnp.asarray(_dhcw(ct)))
    np.testing.assert_allclose(y, _dhcw(np.asarray(y_j)), atol=ATOL)
    np.testing.assert_allclose(dx, _dhcw(np.asarray(dx_j)), atol=ATOL)
    np.testing.assert_allclose(dw, np.asarray(dk_j).transpose(4, 3, 0, 1, 2),
                               atol=ATOL)


@pytest.mark.parametrize("k,stride,ci,co,hw", [(3, 1, 8, 8, (12, 20)),
                                               (5, 2, 8, 16, (11, 17)),
                                               (1, 1, 16, 8, (12, 20)),
                                               (3, 1, 8, 1, (9, 13)),
                                               (3, 1, 1, 8, (10, 14))])
def test_conv2d_train_matches_jax_vjp(k, stride, ci, co, hw):
    """Stride-1 3x3 and 1x1, the 5x5 stride-2 downsampling conv at odd
    extents, and refine's Co = 1 tail and Ci = 1 head."""
    rng = np.random.RandomState(30 + k + ci)
    n, (h, w) = 2, hw
    x = rng.randn(n, h, w, ci).astype(np.float32)
    kern = (rng.randn(k, k, ci, co) * 0.2).astype(np.float32)
    ct = rng.randn(n, -(-h // stride), -(-w // stride), co).astype(np.float32)
    y, dx, dw = _port_grads(lambda a, k_: conv2d_train(a, k_, stride), x,
                            np.ascontiguousarray(kern.transpose(3, 2, 0, 1)),
                            ct)
    y_j, vjp = jax.vjp(lambda a, k_: jax_conv2d_train(a, k_, stride, True),
                       jnp.asarray(_dhcw(x)), jnp.asarray(kern))
    dx_j, dk_j = vjp(jnp.asarray(_dhcw(ct)))
    np.testing.assert_allclose(y, _dhcw(np.asarray(y_j)), atol=ATOL)
    np.testing.assert_allclose(dx, _dhcw(np.asarray(dx_j)), atol=ATOL)
    np.testing.assert_allclose(dw, np.asarray(dk_j).transpose(3, 2, 0, 1),
                               atol=1e-3)


def test_conv_train_skips_unneeded_input_grad():
    """An input that needs no gradient (the backbone's images, refine's
    detached depth) gets none, and its weight still does."""
    x = torch.randn(1, 6, 7, 1)
    wt = torch.randn(8, 1, 3, 3, requires_grad=True)
    conv2d_train(x, wt).sum().backward()
    assert x.grad is None and wt.grad is not None
