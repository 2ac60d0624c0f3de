"""The tensor-core (tc) route of the conv kernels on the CPU: its plain
mirrors (``conv_tc_plain`` and, for the transposed conv, ``trconv_tc_plain``,
which consume the packed bf16 weights in the tc kernels' K order) vs the
plain conv and the TPU kernels in Pallas interpret mode, at every (KD, K,
stride, Ci, Co) class the model sends there; the input gradients' flipped
and swapped weights vs ``jax.vjp`` of the Pallas VJPs; and the route rule
on the default model.

Inputs are rounded to bf16 (the kernel's operands) and computed in f32, so
the tolerance (3e-4, the Pallas tests' own) covers the order of the sums
only."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdfnet_tpu.ops.pallas.conv2d_kernel import conv2d_fused
from mdfnet_tpu.ops.pallas.conv2d_vjp import conv2d_train as jax_conv2d_train
from mdfnet_tpu.ops.pallas.conv3d_kernel import (conv3d_bn_relu,
                                                 trconv3d_bn_relu)
from mdfnet_tpu.ops.pallas.conv3d_vjp import (conv3d_train as jax_conv3d_train,
                                              trconv3d_train as
                                              jax_trconv3d_train)
from mdfnet_tpu_torch.models.conv_routes import (conv_classes,
                                                 eval_conv_routes)
from mdfnet_tpu_torch.models.layers import ConvTranspose3dWeight
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.ops.cuda import conv_kernel
from mdfnet_tpu_torch.ops.cuda.conv_kernel import (_conv_plain, conv_route,
                                                   conv_tc_plain,
                                                   pack_tc_weight,
                                                   pack_trconv_tc_weight,
                                                   tc_plan, trconv_tc_plain)

ATOL = 3e-4
# (KD, K, stride, Ci, Co): every class of the default model's bf16 eval
# forward, train forward and train input gradients that the rule sends to
# the tc kernel (test_classes_cover_the_model), and Co = 24 (padded to 32)
TC_CLASSES = [
    (3, 3, 1, 32, 16), (3, 3, 1, 16, 16), (3, 3, 2, 16, 32),
    (3, 3, 1, 32, 32), (3, 3, 2, 32, 64), (3, 3, 1, 64, 64),
    (3, 3, 1, 16, 8), (3, 3, 1, 8, 8), (3, 3, 2, 8, 16), (3, 3, 1, 8, 16),
    (3, 3, 1, 16, 32), (3, 3, 1, 64, 32), (3, 3, 2, 16, 8),
    (1, 5, 2, 8, 16), (1, 5, 2, 16, 32), (1, 5, 2, 32, 64),
    (1, 3, 1, 8, 8), (1, 3, 1, 16, 16), (1, 3, 1, 32, 32), (1, 3, 1, 64, 64),
    (1, 3, 1, 8, 32), (1, 3, 1, 32, 8),
    (1, 1, 1, 16, 64), (1, 1, 1, 32, 64), (1, 1, 1, 64, 16),
    (1, 1, 1, 64, 32), (1, 1, 1, 64, 64),
    (1, 3, 1, 24, 24)]
# (Ci, Co) of the transposed convs on the tc kernel: the model's eval and
# train forwards and the stride-2 convs' input gradients (Ci = 64, 32, 16
# to Co = 32, 16, 8), and Ci = 8, 16, 64 crossed with Co = 8, 16, 32
TR_CLASSES = sorted({(ci, co) for ci in (8, 16, 64) for co in (8, 16, 32)}
                    | {(32, 16)})


def _bf16(a):
    """Round to bf16 and back: the kernel's operands, exact in f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float()


def _kio(w):
    """torch (Co, Ci, *k) -> (KD, k, k, Ci, Co), KD = 1 for 2D."""
    w_kio = w.permute(*range(2, w.dim()), 1, 0)
    return w_kio if w.dim() == 5 else w_kio[None]


def _mirror(x, w, scale, offset, *, stride, relu=True, residual=None,
            out_dtype=torch.float32):
    """conv_tc_plain on w packed as the wrapper packs it."""
    kd = 3 if w.dim() == 5 else 1
    k, ci, co = w.shape[-1], w.shape[1], w.shape[0]
    packed = pack_tc_weight(_kio(w), kd=kd, k=k, stride=stride)
    assert packed.dtype == torch.bfloat16 and packed.shape == (
        kd * k * k * ci // 8, co, 8)
    return conv_tc_plain(x, packed, scale, offset, kd=kd, k=k,
                         stride=stride, relu=relu, residual=residual,
                         out_dtype=out_dtype)


def _model_tc_classes():
    """The classes (KD, K, stride, Ci, Co, transposed) the default bf16
    model sends to the tc kernel: its convs and transposed convs (eval and
    train forward), the stride-1 convs' input gradients (a conv from Co to
    Ci), the transposed convs' (a stride-2 conv from their Co to their Ci)
    and the stride-2 conv3ds' (a transposed conv from their Co to their
    Ci)."""
    model = build_model(compute_dtype="bfloat16", device="cpu")
    classes = set()
    for m in (model.Backbone, *model.Regular, model.Refine):
        for kd, k, s, ci, co, tr in conv_classes(m):
            classes.add((kd, k, s, ci, co, tr))
            if tr:
                classes.add((3, 3, 2, co, ci, False))
            elif s == 1:
                classes.add((kd, k, 1, co, ci, False))
            elif kd == 3:
                classes.add((3, 3, 2, co, ci, True))
        assert len([t for t in m.modules()
                    if isinstance(t, ConvTranspose3dWeight)]) == \
            sum(c[-1] for c in conv_classes(m))
    return {c for c in classes if conv_route(torch.bfloat16, *c) == "tc"}


def test_classes_cover_the_model():
    assert _model_tc_classes() <= (
        {(*c, False) for c in TC_CLASSES}
        | {(3, 3, 2, ci, co, True) for ci, co in TR_CLASSES})


@pytest.mark.parametrize("kd,k,stride,ci,co", TC_CLASSES)
def test_mirror_matches_plain_conv(kd, k, stride, ci, co):
    """Odd extents (ragged tiles, stride 2 with odd D/H/W), a residual
    after the ReLU and an f32 output."""
    rng = np.random.RandomState(ci * 7 + co + 100 * stride + kd)
    shape = (2, 5, 7, 9) if kd == 3 else (2, 13, 11)
    x = _bf16(rng.randn(*shape, ci).astype(np.float32))
    w = _bf16((rng.randn(co, ci, *(k,) * len(shape[1:])) * 0.2)
              .astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(co)).astype(np.float32))
    offset = torch.from_numpy(rng.randn(co).astype(np.float32))
    out = [(e + stride - 1) // stride for e in shape[1:]]
    res = torch.from_numpy(rng.randn(shape[0], *out, co).astype(np.float32))
    got = _mirror(x, w, scale, offset, stride=stride, residual=res)
    want = _conv_plain(x, w, scale, offset, stride=stride, relu=True,
                       residual=res, out_dtype=torch.float32)
    assert got.shape == want.shape == (shape[0], *out, co)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def _pallas(x, w, scale, offset, stride):
    """The TPU kernel in interpret mode on the port's layouts, or None
    where it takes no such conv (conv2d_fused: k 1/3 at stride 1, k 3/5 at
    stride 2)."""
    k = np.asarray(_kio(w)[0] if w.dim() == 4 else _kio(w))
    args = (jnp.asarray(scale.numpy()), jnp.asarray(offset.numpy()))
    if w.dim() == 5:
        out = conv3d_bn_relu(jnp.asarray(x[0].numpy().transpose(0, 1, 3, 2)),
                             jnp.asarray(k), *args, stride=stride,
                             interpret=True)
        return np.asarray(out).transpose(0, 1, 3, 2)[None]
    if (k.shape[0], stride) in ((1, 2), (5, 1)):
        return None
    out = conv2d_fused(jnp.asarray(x.numpy().transpose(0, 1, 3, 2)),
                       jnp.asarray(k), *args, th=4, stride=stride,
                       interpret=True)
    return np.asarray(out).transpose(0, 1, 3, 2)


@pytest.mark.parametrize("kd,k,stride,ci,co", TC_CLASSES)
def test_mirror_matches_pallas(kd, k, stride, ci, co):
    rng = np.random.RandomState(ci + co + 10 * k + stride)
    shape = (1, 4, 6, 10) if kd == 3 else (2, 12, 20)
    x = _bf16(rng.randn(*shape, ci).astype(np.float32))
    w = _bf16((rng.randn(co, ci, *(k,) * len(shape[1:])) * 0.2)
              .astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(co)).astype(np.float32))
    offset = torch.from_numpy(rng.randn(co).astype(np.float32))
    want = _pallas(x, w, scale, offset, stride)
    if want is None:
        want = _conv_plain(x, w, scale, offset, stride=stride, relu=True,
                           residual=None, out_dtype=torch.float32).numpy()
    got = _mirror(x, w, scale, offset, stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def _tr_mirror(x, w, scale, offset, *, relu=True, residual=None,
               out_dtype=torch.float32):
    """trconv_tc_plain on the (Ci, Co, 3, 3, 3) weight packed as the
    wrapper packs it."""
    ci, co = w.shape[:2]
    packed = pack_trconv_tc_weight(w.permute(2, 3, 4, 0, 1))
    assert packed.dtype == torch.bfloat16 and packed.shape == (
        18 * ci // 8, 2 * co, 8)
    return trconv_tc_plain(x, packed, scale, offset, relu=relu,
                           residual=residual, out_dtype=out_dtype)


def _tr_operands(rng, shape, ci, co):
    x = _bf16(rng.randn(*shape, ci).astype(np.float32))
    w = _bf16((rng.randn(ci, co, 3, 3, 3) * 0.2).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(co)).astype(np.float32))
    offset = torch.from_numpy(rng.randn(co).astype(np.float32))
    res = torch.from_numpy(rng.randn(
        shape[0], *(2 * e for e in shape[1:]), co).astype(np.float32))
    return x, w, scale, offset, res


@pytest.mark.parametrize("ci,co", TR_CLASSES)
def test_trconv_mirror_matches_plain_conv(ci, co):
    """The transposed conv's mirror at odd D/H/W (ragged coarse tiles, the
    far-end halo), a residual after the ReLU and an f32 output."""
    rng = np.random.RandomState(ci * 5 + co)
    x, w, scale, offset, res = _tr_operands(rng, (2, 3, 5, 7), ci, co)
    got = _tr_mirror(x, w, scale, offset, residual=res)
    want = _conv_plain(x, w, scale, offset, stride=2, relu=True,
                       residual=res, out_dtype=torch.float32, transposed=True)
    assert got.shape == want.shape == (2, 6, 10, 14, co)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("ci,co", [(64, 32), (32, 16), (16, 8), (8, 16)])
def test_trconv_mirror_matches_pallas(ci, co):
    """vs the TPU kernel (``trconv3d_bn_relu``, interpret mode) plus the
    skip, which the Pallas kernel leaves to its caller."""
    rng = np.random.RandomState(60 + ci + co)
    x, w, scale, offset, res = _tr_operands(rng, (1, 3, 4, 5), ci, co)
    kern = w.permute(2, 3, 4, 1, 0).numpy()     # JAX: (*k, O, I)
    pallas = trconv3d_bn_relu(jnp.asarray(x[0].numpy().transpose(0, 1, 3, 2)),
                              jnp.asarray(kern), jnp.asarray(scale.numpy()),
                              jnp.asarray(offset.numpy()), interpret=True)
    want = np.asarray(pallas).transpose(0, 1, 3, 2)[None] + res.numpy()
    got = _tr_mirror(x, w, scale, offset, residual=res).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def _dhcw(a):   # (B, D, H, W, C) <-> (B, D, H, C, W)
    return np.ascontiguousarray(np.swapaxes(a, -1, -2))


@pytest.mark.parametrize("kind,shape,ci,co", [
    ("conv3d", (2, 5, 6, 9), 16, 32),     # d_input: a conv 32 -> 16
    ("conv3d", (1, 4, 5, 7), 8, 16),
    # d_input of a stride-2 conv: the transposed conv 32 -> 16, cropped
    ("conv3d_s2", (2, 5, 6, 9), 16, 32),
    ("conv3d_s2", (1, 4, 7, 6), 32, 64),
    ("trconv3d", (1, 3, 4, 5), 32, 16),   # d_input: a stride-2 conv 16 -> 32
    ("trconv3d", (2, 3, 3, 4), 16, 8),
    ("conv2d", (2, 11, 13), 8, 8),
    ("conv2d", (2, 9, 10), 32, 64)])
def test_mirror_input_gradient_matches_jax_vjp(kind, shape, ci, co):
    """The input gradients that K8 sends to the tc kernel, on the weights
    conv_vjp.py gives it: a stride-1 conv's weight flipped in space with
    (Co, Ci) swapped, the transposed conv's own (Ci, Co) weight read as a
    stride-2 conv's (out, in), and a stride-2 conv's own (Co, Ci) weight
    read as the transposed conv's (in, out), its output cropped to the
    input; vs ``jax.vjp`` of the Pallas VJPs."""
    rng = np.random.RandomState(ci + 3 * co)
    x = rng.randn(*shape, ci).astype(np.float32)
    nk = 2 if kind == "conv2d" else 3
    if kind == "trconv3d":
        # JAX stores a transposed conv's weight as (*k, O, I)
        kern = _bf16((rng.randn(3, 3, 3, co, ci) * 0.1).astype(np.float32))
        out = [2 * e for e in shape[1:]]
    elif kind == "conv3d_s2":
        kern = _bf16((rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32))
        out = [(e + 1) // 2 for e in shape[1:]]
    else:
        kern = _bf16((rng.randn(*(3,) * nk, ci, co) * 0.1)
                     .astype(np.float32))
        out = list(shape[1:])
    ct = _bf16(rng.randn(shape[0], *out, co).astype(np.float32))
    # the torch layouts: a conv (Co, Ci, *k), a transposed conv (Ci, Co, *k)
    w = torch.movedim(kern, (-1, -2), (0, 1)).contiguous()
    ones, zeros = torch.ones(ci), torch.zeros(ci)
    if kind == "trconv3d":
        got = _mirror(ct, w, ones, zeros, stride=2, relu=False)
        jax_fn = (lambda a, k_: jax_trconv3d_train(a, k_, True))
    elif kind == "conv3d_s2":
        d, h, w_ = shape[1:]
        got = _tr_mirror(ct, w, ones, zeros, relu=False)[:, :d, :h, :w_]
        jax_fn = (lambda a, k_: jax_conv3d_train(a, k_, 2, True))
    else:
        flip = tuple(range(2, w.dim()))
        got = _mirror(ct, w.transpose(0, 1).flip(flip), ones, zeros,
                      stride=1, relu=False)
        fn = jax_conv3d_train if kind == "conv3d" else jax_conv2d_train
        jax_fn = (lambda a, k_: fn(a, k_, 1, True))
    kj = kern.numpy()
    _, vjp = jax.vjp(jax_fn, jnp.asarray(_dhcw(x)), jnp.asarray(kj))
    dx_j, _ = vjp(jnp.asarray(_dhcw(ct.numpy())))
    want = _dhcw(np.asarray(dx_j))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_default_model_routes():
    """One bf16 eval forward of the default model: 53 tc launches (22 of
    K2's 25, all 8 of K3's, 7 of K4's 8, 16 of K5's 18), 4 on the co1
    kernel (Co = 1: three ProbConvs, refine's tail) and a direct remainder
    of Ci in {3, 1} (the trunk's and refine's heads); in f32 every conv is
    direct but the four to Co = 1."""
    model = build_model(compute_dtype="bfloat16", device="cpu")
    routes = eval_conv_routes(model)
    assert collections.Counter(routes) == {"tc": 53, "co1": 4, "direct": 2}
    per_part = {
        "Backbone": conv_classes(model.Backbone),
        "Regular": [c for r in model.Regular for c in conv_classes(r)],
        "Refine": conv_classes(model.Refine)}
    tc = {name: sum(conv_route(torch.bfloat16, *c) == "tc" for c in cl)
          for name, cl in per_part.items()}
    assert tc == {"Backbone": 15, "Regular": 30, "Refine": 8}
    transposed = sorted(c for c in per_part["Regular"] if c[-1])
    assert transposed == [(3, 3, 2, 16, 8, True)] * 2 + [
        (3, 3, 2, 32, 16, True)] * 3 + [(3, 3, 2, 64, 32, True)] * 3
    def routed(route):
        return sorted(c[:5] for cl in per_part.values() for c in cl
                      if conv_route(torch.bfloat16, *c) == route)
    assert routed("direct") == [(1, 3, 1, 1, 8), (1, 3, 1, 3, 8)]
    assert routed("co1") == [(1, 3, 1, 8, 1), (3, 3, 1, 8, 1),
                             (3, 3, 1, 8, 1), (3, 3, 1, 16, 1)]
    f32 = build_model(device="cpu")
    assert collections.Counter(eval_conv_routes(f32)) == {"direct": 55,
                                                          "co1": 4}


@pytest.mark.parametrize("args,route", [
    ((torch.bfloat16, 3, 3, 1, 32, 16), "tc"),
    ((torch.float32, 3, 3, 1, 32, 16), "direct"),
    ((torch.bfloat16, 3, 3, 1, 16, 1), "co1"),
    ((torch.bfloat16, 1, 3, 1, 3, 8), "direct"),
    ((torch.bfloat16, 1, 3, 1, 8, 12), "direct"),
    ((torch.bfloat16, 1, 3, 1, 8, 128), "direct"),
    ((torch.bfloat16, 3, 3, 2, 64, 64), "direct"),    # no tile fits
    ((torch.bfloat16, 3, 3, 2, 32, 16), "direct"),
    # the transposed conv: bf16, Ci and Co multiples of 8, Co <= 32
    ((torch.bfloat16, 3, 3, 2, 32, 16, True), "tc"),
    ((torch.bfloat16, 3, 3, 2, 64, 32, True), "tc"),
    ((torch.bfloat16, 3, 3, 2, 8, 8, True), "tc"),
    ((torch.float32, 3, 3, 2, 32, 16, True), "direct"),
    ((torch.bfloat16, 3, 3, 2, 64, 64, True), "direct"),
    ((torch.bfloat16, 3, 3, 2, 12, 8, True), "direct")])
def test_route_rule(args, route):
    assert conv_route(*args) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kd", [1, 3])
@pytest.mark.parametrize("ci", [8, 16, 24, 32, 64])
def test_route_rule_sends_every_co1_conv_to_the_co1_kernel(dtype, kd, ci):
    """Every K = 3 stride-1 conv to Co = 1 with Ci a multiple of 8 takes
    the co1 kernel, bf16 or f32; Ci in {1, 3}, another K or stride, or a
    transposed conv does not."""
    assert conv_route(dtype, kd, 3, 1, ci, 1) == "co1"
    for args in ((kd, 3, 1, 3, 1), (kd, 3, 1, 1, 1), (kd, 3, 2, ci, 1),
                 (1, 5, 1, ci, 1), (1, 1, 1, ci, 1)):
        assert conv_route(dtype, *args) == "direct"
    assert conv_route(dtype, 3, 3, 2, ci, 1, True) == "direct"


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kd", [1, 3])
def test_co1_plans_fit(kd, itemsize):
    """The co1 kernel's tile (csrc/conv_co1.cu: 256 threads, 4 outputs
    each along w, a w tile of 32) fits the 227 KB a block may hold for
    every Ci up to 64, f32 or bf16; its channels per stage (8 or 16)
    divide Ci, and every Ci <= 16 (all the model's convs to Co = 1) goes
    in one stage, where the kernel sums in the direct kernel's order."""
    for ci in range(8, 65, 8):
        plan = conv_kernel.co1_plan(kd, ci, itemsize)
        assert plan.smem <= 227 * 1024
        assert (plan.td, plan.th, plan.tw) == ((4, 8, 32) if kd == 3
                                               else (1, 32, 32))
        assert plan.td * plan.th * plan.tw == 256 * 4
        assert plan.channels in (8, 16) and ci % plan.channels == 0
        assert (plan.channels == ci) == (ci <= 16)
    assert conv_kernel.co1_plan(kd, 12, itemsize) is None


def test_plans_fit_and_pack_in_the_kernel_order():
    """Every class's tile fits the 227 KB a block may hold, with 2 * MB
    M blocks; the packed weights hold chunk q = ((kd*K + kh)*Ci/8 + c)*K +
    slot at row q, slots listing even kw first at stride 2."""
    for kd, k, s, ci, co in TC_CLASSES:
        plan = tc_plan(kd, k, s, ci, co)
        assert plan.smem <= 227 * 1024
        assert plan.td * plan.bh == 2 * conv_kernel._TC_MB[plan.n]
        assert plan.q % plan.q_stage == 0 and plan.q % 2 == 0
    def padded(d, h, td, bh):
        return -(-d // td) * td * -(-h // (8 * bh)) * 8 * bh
    for (ci, co), (d, h) in zip(TR_CLASSES * 3, [(0, 0)] * len(TR_CLASSES)
                                + [(1, 74)] * 10 + [(3, 37)] * 10):
        plan = tc_plan(3, 3, 2, ci, co, True, d, h)
        assert plan.smem <= 227 * 1024 and plan.n >= 2 * co
        mblocks = 2 * conv_kernel._TC_MB[plan.n]
        assert plan.td * plan.bh == mblocks
        assert plan.q == 18 * ci // 8 and plan.q_stage in (plan.q, 8 * ci // 8)
        # the tile pads D x H least
        assert padded(d, h, plan.td, plan.bh) == min(
            padded(d, h, t, mblocks // t) for t in (1, 2, 4, 8)
            if t <= mblocks)
    # blocks per coarse tile: the fewest that give 132 SMs two blocks each
    assert [conv_kernel.trconv_tc_groups(t, 132)
            for t in (780, 264, 263, 132, 35)] == [1, 1, 2, 2, 4]
    w = torch.randn(16, 16, 3, 5, 5)[:, :, :1]       # (Co, Ci, 1, 5, 5)
    packed = pack_tc_weight(_kio(w), kd=1, k=5, stride=2)
    assert packed.shape == (50, 16, 8) and packed.is_contiguous()
    for kh, c, slot in ((0, 0, 0), (2, 1, 3), (4, 1, 4), (3, 0, 2)):
        kw = [0, 2, 4, 1, 3][slot]
        q = (kh * 2 + c) * 5 + slot
        torch.testing.assert_close(
            packed[q].float(), w[:, 8 * c:8 * c + 8, 0, kh, kw]
            .to(torch.bfloat16).float(), rtol=0, atol=0)
    # the transposed conv: chunk 18c + j, even w parity then odd, per the
    # kernel's GEMM order; GEMM (1, 1) at offsets (od, oh, ow) = (1, 0, 1)
    # is chunk 10 + 2 * 2 + 1: k = (0, 2, 0) for the odd parity, none for
    # the even one
    wt = torch.randn(16, 8, 3, 3, 3)
    packed = pack_trconv_tc_weight(wt.permute(2, 3, 4, 0, 1))
    assert packed.shape == (36, 16, 8) and packed.is_contiguous()
    for c, j, pw, k in ((0, 0, 0, (1, 1, 1)), (1, 0, 1, (1, 1, 2)),
                        (1, 15, 1, (0, 2, 0)), (0, 11, 1, (2, 2, 0)),
                        (1, 2, 1, (1, 2, 2)), (0, 5, 1, (1, 0, 0))):
        torch.testing.assert_close(
            packed[18 * c + j, 8 * pw:8 * pw + 8].float(),
            wt[8 * c:8 * c + 8, :, k[0], k[1], k[2]].T.to(torch.bfloat16)
            .float(), rtol=0, atol=0)


def test_cpu_route_override_takes_the_plain_version():
    """On the CPU ``route`` selects nothing: the plain version, no launch."""
    before = dict(conv_kernel.LAUNCHES)
    x = torch.randn(1, 4, 6, 8, 16)
    w = torch.randn(8, 16, 3, 3, 3)
    ones, zeros = torch.ones(8), torch.zeros(8)
    for route in ("tc", "direct"):
        got = conv_kernel.conv3d_bn_act(x, w, ones, zeros, route=route)
        torch.testing.assert_close(got, conv_kernel.conv3d_bn_act(
            x, w, ones, zeros))
    w1 = torch.randn(1, 16, 3, 3, 3)
    for route in ("co1", "direct"):
        got = conv_kernel.conv3d_bn_act(x, w1, ones[:1], zeros[:1],
                                        route=route)
        torch.testing.assert_close(got, conv_kernel.conv3d_bn_act(
            x, w1, ones[:1], zeros[:1]))
    assert conv_kernel.LAUNCHES == before
