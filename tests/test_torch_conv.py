"""The conv kernels' plain versions (K2-K5, through their CPU wrappers) vs
the TPU kernels in Pallas interpret mode and vs the XLA convolution.

Layouts: the TPU kernels take (D, H, C, W) / (N, H, C, W) and (*k, I, O)
weights; the port takes NDHWC / NHWC and torch-layout weights, so the test
transposes. All f32; tolerances cover summation order only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import to_torch
from mdfnet_tpu.ops.pallas.conv2d_kernel import (conv2d_chain_fused,
                                                 conv2d_fused)
from mdfnet_tpu.ops.pallas.conv3d_kernel import (conv3d_bn_relu,
                                                 conv3d_pair_bn_relu,
                                                 trconv3d_bn_relu)
from mdfnet_tpu_torch.ops.cuda import conv_kernel
from mdfnet_tpu_torch.ops.cuda.conv_kernel import (
    conv2d_bn_act, conv2d_chain, conv3d_bn_act, conv3d_pair_bn_act,
    trconv3d_bn_act)

ATOL = 3e-4   # the Pallas tests' own bound for f32 sums of <= 1728 terms


def _epilogue(rng, co):
    return ((0.5 + rng.rand(co)).astype(np.float32),
            rng.randn(co).astype(np.float32))


def _torch_weight(k):
    """(*k, I, O) -> torch (O, I, *k); a transposed conv's stored (*k, O, I)
    -> torch (I, O, *k) is the same permutation."""
    return np.ascontiguousarray(np.moveaxis(k, (-1, -2), (0, 1)))


def _xla_conv(x, k, stride, nd):
    spec = ("NDHWC", "DHWIO", "NDHWC") if nd == 3 else ("NHWC", "HWIO",
                                                         "NHWC")
    p = k.shape[0] // 2
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride,) * nd, [(p, p)] * nd,
        dimension_numbers=spec))


@pytest.mark.parametrize("stride,ci,co", [(1, 8, 16), (2, 16, 8), (1, 8, 1)])
def test_conv3d_matches_pallas_and_xla(stride, ci, co):
    rng = np.random.RandomState(20 + stride)
    d, h, w = 4, 6, 10
    x = rng.randn(1, d, h, w, ci).astype(np.float32)
    k = (rng.randn(3, 3, 3, ci, co) * 0.2).astype(np.float32)
    scale, offset = _epilogue(rng, co)
    got = conv3d_bn_act(*to_torch(x, _torch_weight(k), scale, offset),
                        stride=stride).numpy()
    pallas = conv3d_bn_relu(jnp.asarray(x[0].transpose(0, 1, 3, 2)),
                            jnp.asarray(k), jnp.asarray(scale),
                            jnp.asarray(offset), stride=stride, interpret=True)
    np.testing.assert_allclose(got[0], np.asarray(pallas).transpose(0, 1, 3, 2),
                               atol=ATOL)
    xla = np.maximum(_xla_conv(x, k, stride, 3) * scale + offset, 0.0)
    np.testing.assert_allclose(got, xla, atol=ATOL)


@pytest.mark.parametrize("ci,co", [(16, 8), (8, 8)])
def test_trconv3d_matches_pallas(ci, co):
    rng = np.random.RandomState(30 + ci)
    d, h, w = 3, 4, 5
    x = rng.randn(1, d, h, w, ci).astype(np.float32)
    k = (rng.randn(3, 3, 3, co, ci) * 0.2).astype(np.float32)  # (*k, O, I)
    scale, offset = _epilogue(rng, co)
    skip = rng.randn(1, 2 * d, 2 * h, 2 * w, co).astype(np.float32)
    got = trconv3d_bn_act(*to_torch(x, _torch_weight(k), scale, offset),
                          residual=torch.from_numpy(skip)).numpy()
    pallas = trconv3d_bn_relu(jnp.asarray(x[0].transpose(0, 1, 3, 2)),
                              jnp.asarray(k), jnp.asarray(scale),
                              jnp.asarray(offset), interpret=True)
    want = np.asarray(pallas).transpose(0, 1, 3, 2)[None] + skip
    assert got.shape == want.shape == (1, 2 * d, 2 * h, 2 * w, co)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ks", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_matches_pallas_and_xla(ks, stride):
    rng = np.random.RandomState(40 + 2 * ks + stride)
    n, h, w, ci, co = 2, 12, 20, 8, 16
    x = rng.randn(n, h, w, ci).astype(np.float32)
    k = (rng.randn(ks, ks, ci, co) * 0.2).astype(np.float32)
    scale, offset = _epilogue(rng, co)
    relu = ks != 1     # the 1x1 laterals are conv + bias, no ReLU
    got = conv2d_bn_act(*to_torch(x, _torch_weight(k), scale, offset),
                        stride=stride, relu=relu).numpy()
    xla = _xla_conv(x, k, stride, 2) * scale + offset
    np.testing.assert_allclose(got, np.maximum(xla, 0.0) if relu else xla,
                               atol=ATOL)
    if (ks, stride) in ((1, 2), (5, 1)):
        return   # conv2d_fused takes k 1/3 at stride 1, k 3/5 at stride 2
    pallas = conv2d_fused(jnp.asarray(x.transpose(0, 1, 3, 2)),
                          jnp.asarray(k), jnp.asarray(scale),
                          jnp.asarray(offset), th=4, stride=stride,
                          relu=relu, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas).transpose(0, 1, 3, 2),
                               atol=ATOL)


def test_conv2d_out_f32_and_residual():
    """Co = 1 with an f32 output (refine's tail) and a residual add after
    the ReLU (the FPN laterals' upsampled addend)."""
    rng = np.random.RandomState(50)
    x = rng.randn(1, 9, 11, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 1) * 0.2).astype(np.float32)
    res = rng.randn(1, 9, 11, 1).astype(np.float32)
    got = conv2d_bn_act(*to_torch(x, _torch_weight(k), np.ones(1, np.float32),
                                  np.zeros(1, np.float32)),
                        residual=torch.from_numpy(res),
                        out_dtype=torch.float32).numpy()
    want = np.maximum(_xla_conv(x, k, 1, 2), 0.0) + res
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kd,ci", [(3, 16), (3, 8), (1, 8)])
def test_co1_route_matches_pallas(kd, ci):
    """The convs to Co = 1 that the co1 kernel takes (the ProbConvs,
    refine's tail; no ReLU, f32 out): with ``route="co1"`` a CPU tensor
    runs the plain version, held to the Pallas conv (conv3d_bn_relu or
    conv2d_fused at Co = 1) in interpret mode."""
    rng = np.random.RandomState(60 + ci + kd)
    shape = (1, 4, 6, 10) if kd == 3 else (1, 12, 20)
    x = rng.randn(*shape, ci).astype(np.float32)
    k = (rng.randn(*(3,) * (3 if kd == 3 else 2), ci, 1) * 0.2
         ).astype(np.float32)
    scale, offset = np.ones(1, np.float32), rng.randn(1).astype(np.float32)
    conv = conv3d_bn_act if kd == 3 else conv2d_bn_act
    before = dict(conv_kernel.LAUNCHES)
    got = conv(*to_torch(x, _torch_weight(k), scale, offset), relu=False,
               out_dtype=torch.float32, route="co1").numpy()
    assert conv_kernel.LAUNCHES == before
    if kd == 3:
        pallas = conv3d_bn_relu(jnp.asarray(x[0].transpose(0, 1, 3, 2)),
                                jnp.asarray(k), jnp.asarray(scale),
                                jnp.asarray(offset), relu=False,
                                interpret=True)
        want = np.asarray(pallas).transpose(0, 1, 3, 2)[None]
    else:
        pallas = conv2d_fused(jnp.asarray(x.transpose(0, 1, 3, 2)),
                              jnp.asarray(k), jnp.asarray(scale),
                              jnp.asarray(offset), th=4, relu=False,
                              interpret=True)
        want = np.asarray(pallas).transpose(0, 1, 3, 2)
    assert got.shape == want.shape == shape + (1,)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("final_stride", [1, 2])
def test_chain_matches_pallas(final_stride):
    """Res-style chain: conv-ReLU, conv x0.1 + skip of layer 0, then a last
    layer that is 3x3 (stride 1) or 5x5 stride 2 (the trunk's transition)."""
    rng = np.random.RandomState(60 + final_stride)
    n, h, w, c = 2, 14, 22, 8
    x = rng.randn(n, h, w, c).astype(np.float32)
    klast = 5 if final_stride == 2 else 3
    shapes = [(3, c, c), (3, c, c), (3, c, c), (klast, c, 16)]
    ks = [(rng.randn(s, s, i, o) * 0.2).astype(np.float32)
          for s, i, o in shapes]
    scales = [np.ones(c, np.float32), np.ones(c, np.float32),
              np.full(c, 0.1, np.float32), (0.5 + rng.rand(16))
              .astype(np.float32)]
    offsets = [rng.randn(s.shape[0]).astype(np.float32) * 0.1
               for s in scales]
    relus = (True, True, False, True)
    resid = (None, None, 0, None)
    got = conv2d_chain(torch.from_numpy(x),
                       [torch.from_numpy(_torch_weight(k)) for k in ks],
                       to_torch(*scales), to_torch(*offsets),
                       relu_flags=relus, residuals=resid,
                       final_stride=final_stride).numpy()
    pallas = conv2d_chain_fused(
        jnp.asarray(x.transpose(0, 1, 3, 2)), [jnp.asarray(k) for k in ks],
        [jnp.asarray(s) for s in scales], [jnp.asarray(o) for o in offsets],
        th=4, relu_flags=relus, residuals=resid, final_stride=final_stride,
        interpret=True)
    want = np.asarray(pallas).transpose(0, 1, 3, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cpu_wrappers_launch_nothing():
    """CPU tensors take the plain versions: no build, counters unchanged."""
    before = dict(conv_kernel.LAUNCHES)
    x = torch.randn(1, 2, 4, 6, 8)
    w = torch.randn(8, 8, 3, 3, 3)
    ones, zeros = torch.ones(8), torch.zeros(8)
    conv3d_bn_act(x, w, ones, zeros)
    trconv3d_bn_act(x, w, ones, zeros)
    conv2d_bn_act(x[:, 0], w[..., 0], ones, zeros)
    conv2d_chain(x[:, 0], [w[..., 0]], [ones], [zeros])
    assert conv_kernel.LAUNCHES == before


def _pair_inputs(rng, shape, ci, cm, co):
    x = rng.randn(*shape, ci).astype(np.float32)
    k1 = (rng.randn(3, 3, 3, ci, cm) * 0.2).astype(np.float32)
    k2 = (rng.randn(3, 3, 3, cm, co) * 0.2).astype(np.float32)
    # offsets well away from 0: an intermediate voxel outside the volume
    # that took relu(o1) instead of zero would show at every border
    s1, o1 = (0.5 + rng.rand(cm)).astype(np.float32), \
        (0.5 + rng.rand(cm)).astype(np.float32)
    s2, o2 = _epilogue(rng, co)
    return x, k1, s1, o1, k2, s2, o2


def _port_pair(x, k1, s1, o1, k2, s2, o2, relu=True):
    return conv3d_pair_bn_act(*to_torch(x, _torch_weight(k1), s1, o1,
                                        _torch_weight(k2), s2, o2),
                              relu=relu).numpy()


def test_conv3d_pair_matches_pallas():
    """The plain pair vs the TPU pair kernel (interpret mode), one tiny
    shape: the same two chained layers, f32."""
    rng = np.random.RandomState(70)
    x, k1, s1, o1, k2, s2, o2 = _pair_inputs(rng, (1, 3, 4, 6), 8, 8, 8)
    got = _port_pair(x, k1, s1, o1, k2, s2, o2)
    pallas = conv3d_pair_bn_relu(
        jnp.asarray(x[0].transpose(0, 1, 3, 2)), jnp.asarray(k1),
        jnp.asarray(s1), jnp.asarray(o1), jnp.asarray(k2), jnp.asarray(s2),
        jnp.asarray(o2), th=4, td=2, interpret=True)
    np.testing.assert_allclose(got[0], np.asarray(pallas).transpose(0, 1, 3, 2),
                               atol=ATOL)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,ci,cm,co", [((1, 3, 5, 7), 3, 8, 1),
                                            ((2, 5, 9, 11), 16, 8, 12)])
def test_conv3d_pair_matches_xla(shape, ci, cm, co, relu):
    """The plain pair vs two XLA convolutions with the folded epilogues, at
    odd extents, Ci not a multiple of 8, Co = 1 and Co = 12."""
    rng = np.random.RandomState(71 + ci)
    x, k1, s1, o1, k2, s2, o2 = _pair_inputs(rng, shape, ci, cm, co)
    act = (lambda v: np.maximum(v, 0.0)) if relu else (lambda v: v)
    mid = act(_xla_conv(x, k1, 1, 3) * s1 + o1)
    want = act(_xla_conv(mid, k2, 1, 3) * s2 + o2)
    got = _port_pair(x, k1, s1, o1, k2, s2, o2, relu=relu)
    assert got.shape == want.shape == shape + (co,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv3d_pair_cpu_wrapper_launches_nothing():
    before = dict(conv_kernel.LAUNCHES)
    x = torch.randn(1, 2, 4, 6, 8)
    w = torch.randn(8, 8, 3, 3, 3)
    ones, zeros = torch.ones(8), torch.zeros(8)
    conv3d_pair_bn_act(x, w, ones, zeros, w, ones, zeros)
    assert conv_kernel.LAUNCHES == before
