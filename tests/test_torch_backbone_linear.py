"""The port's eval backbone: its linearised top-down path (the 1x1
out-convs first, each lateral composed with the out-convs after it, three
K4 launches) and ``emit_diffs`` (the G-channel pair differences), against
JAX's eval backbone of the same form (``FPN4Scales(pallas_eval=True)``, its
Pallas kernels in interpret mode) and against the port's own reference
composition (upsample, lateral add, out-conv), f32, at SMALL widths."""
import contextlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import SMALL, jax_model_and_port, scene_args, to_torch
from mdfnet_tpu.models.backbone import FPN4Scales as JaxFPN
from mdfnet_tpu.ops.pallas import conv2d_kernel
from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.ops.sample import resize_bilinear_2x, upsample_2x_nhwc

# f32 on both sides: the composed 1x1 convs re-associate sums whose terms
# are O(1), and XLA and ATen accumulate in other orders (~1e-6)
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def small():
    _, variables, port = jax_model_and_port(SMALL, scene_args(64, 96, 3))
    sub = {"params": variables["params"]["backbone"],
           "batch_stats": variables["batch_stats"]["backbone"]}
    x = np.random.RandomState(1).rand(3, 64, 96, 3).astype(np.float32)
    return sub, port.Backbone, x


def _interpret():
    """JAX's 2D conv kernels (K4, K5) in interpret mode, as the JAX
    package's own tests run them on the CPU."""
    stack = contextlib.ExitStack()
    for name in ("conv2d_fused", "conv2d_chain_fused"):
        orig = getattr(conv2d_kernel, name)

        def forced(*a, _o=orig, **kw):
            kw["interpret"] = True
            return _o(*a, **kw)
        stack.enter_context(mock.patch.object(conv2d_kernel, name, forced))
    return stack


def _trunk_and_top_down(bb, x, emit_diffs):
    """The port's eval backbone with ``emit_diffs`` set, and the trunk's
    outputs (x2, x3, x4) that its top-down path took."""
    seen = {}
    top_down = bb._top_down

    def capture(x2, x3, x4, plain):
        seen["x"] = (x2, x3, x4)
        return top_down(x2, x3, x4, plain)
    bb.emit_diffs = emit_diffs
    with mock.patch.object(bb, "_top_down", capture):
        out = bb(torch.from_numpy(x))
    bb.emit_diffs = True
    return out, seen["x"]


def _reference_composition(bb, x2, x3, x4):
    """The reference's top-down path: upsample, lateral add, out-conv."""
    y4 = bb.out4(x4, plain=True)
    x3 = bb.lat3(x3, residual=upsample_2x_nhwc(x4), plain=True)
    y3 = bb.out3(x3, plain=True)
    x2 = bb.lat2(x2, residual=upsample_2x_nhwc(x3), plain=True)
    return y4, y3, bb.out2(x2, plain=True)


@pytest.mark.parametrize("emit_diffs", [True, False])
def test_eval_backbone_matches_jax_linearised(small, emit_diffs):
    """Against JAX's eval backbone (the same linearised form, its
    ``emit_diffs`` differencing the out-conv kernels), interpret mode."""
    sub, bb, x = small
    with _interpret():
        ref = JaxFPN(SMALL.chs, pallas_eval=True, emit_diffs=emit_diffs) \
            .apply(sub, jnp.asarray(x), False)
    got, _ = _trunk_and_top_down(bb, x, emit_diffs)
    for r, g, c in zip(ref, got, SMALL.chs[::-1]):
        r = np.asarray(r).transpose(0, 1, 3, 2)     # (N, H, C, W) -> NHWC
        assert g.shape == r.shape
        assert g.shape[-1] == (c // 2 if emit_diffs else c)
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("emit_diffs", [True, False])
def test_eval_backbone_matches_the_reference_composition(small, emit_diffs):
    """Against the port's own reference composition on the same trunk
    outputs, differenced where the backbone emits differences."""
    _, bb, x = small
    got, (x2, x3, x4) = _trunk_and_top_down(bb, x, emit_diffs)
    for g, r in zip(got, _reference_composition(bb, x2, x3, x4)):
        if emit_diffs:
            r = r[..., 0::2] - r[..., 1::2]
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_top_down_is_three_composed_convs():
    """Three 1x1 convs at the default widths: x4 by [out4 | out3 | out2]
    (64 -> 32 + 16 + 8 differences), x3 by the two compositions with lat3
    (32 -> 16 + 8), x2 by out2 lat2 (16 -> 8); the offsets carry the
    laterals' biases, the x4 conv has none."""
    bb = build_model(device="cpu").Backbone
    (w4, s4, o4), (w3, s3, o3), (w2, s2, o2) = \
        bb.top_down_weights(torch.bfloat16)
    assert [tuple(w.shape) for w in (w4, w3, w2)] == [
        (56, 64, 1, 1), (24, 32, 1, 1), (8, 16, 1, 1)]
    assert {w.dtype for w in (w4, w3, w2)} == {torch.bfloat16}
    assert {o.dtype for o in (s4, s3, s2, o4, o3, o2)} == {torch.float32}
    assert all(bool((s == 1).all()) for s in (s4, s3, s2))
    assert not o4.any() and o3.abs().sum() > 0 and o2.abs().sum() > 0
    k2 = bb.out2.weight[0::2, :, 0, 0] - bb.out2.weight[1::2, :, 0, 0]
    torch.testing.assert_close(o2, k2 @ bb.lat2.bias, rtol=1e-6, atol=1e-7)


def test_top_down_weights_follow_the_parameters():
    """The composition is kept while the weights stay, made anew when a
    parameter is written (as load_state_dict and an optimizer step do) or
    emit_diffs changes, and leaves the process's matmul precision as it
    was."""
    bb = build_model(device="cpu").Backbone
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        first = bb.top_down_weights(torch.float32)
        assert bb.top_down_weights(torch.float32) is first
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    with torch.no_grad():
        bb.lat2.bias.add_(1.0)
    second = bb.top_down_weights(torch.float32)
    assert second is not first
    k2 = bb.out2.weight[0::2, :, 0, 0] - bb.out2.weight[1::2, :, 0, 0]
    torch.testing.assert_close(second[2][2], k2 @ bb.lat2.bias, rtol=1e-6,
                               atol=1e-6)
    bb.emit_diffs = False
    assert bb.top_down_weights(torch.float32)[2][0].shape[0] == 16


@pytest.mark.parametrize("fields,emits", [
    ({}, True), ({"aggregate_impl": "variance"}, False),
    ({"ngroups": (16, 16, 8)}, False), ({"refine_impl": "refine1"}, True),
    ({"chs": (8, 8, 16, 32), "ngroups": (16, 8, 4)}, True)])
def test_emit_diffs_where_the_vector_aggregate_takes_them(fields, emits):
    """As JAX ``core.py:108-110``: the vector aggregate with C == 2G at
    every stage; the eval forward hands the aggregate what the backbone
    emits."""
    model = build_model(ModelConfig(**fields), device="cpu")
    assert model.Backbone.emit_diffs == emits
    args = to_torch(*scene_args(32, 64, nviews=3, structure="plane"))
    seen = []
    hook = model.Homoaggre[0].register_forward_pre_hook(
        lambda _m, a, kw: seen.append((a[0].shape[-1], kw)), with_kwargs=True)
    model(*args)
    hook.remove()
    c0, g0 = model.Backbone.out4.weight.shape[0], model.Regular[0] \
        .conv01[0].conv.weight.shape[1]
    assert seen[0][0] == (c0 // 2 if emits else c0)
    assert seen[0][1].get("diffs", False) == emits
    assert g0 == (c0 if fields.get("aggregate_impl") == "variance"
                  else (fields.get("ngroups") or (32,))[0])


def _cat_upsample(v):
    """The concatenating 2x stencil the upsample had before: shifted copies
    by ``torch.cat``, even and odd outputs by ``torch.stack``."""
    left = torch.cat([v[..., :1], v[..., :-1]], dim=-1)
    right = torch.cat([v[..., 1:], v[..., -1:]], dim=-1)
    return torch.stack([0.75 * v + 0.25 * left, 0.75 * v + 0.25 * right],
                       dim=-1).reshape(v.shape[:-1] + (2 * v.shape[-1],))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 1, 1), (4, 9, 2)])
def test_upsample_without_cat_keeps_the_bits(dtype, shape):
    """The upsample written into one preallocated tensor gives the bits of
    the concatenating stencil, over the trailing axes and channels-last."""
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape)
                         .astype(np.float32)).to(dtype)
    want = _cat_upsample(_cat_upsample(x).transpose(-1, -2)).transpose(-1, -2)
    assert torch.equal(resize_bilinear_2x(x), want)
    if x.dim() == 4:
        nhwc = x.permute(0, 2, 3, 1)
        assert torch.equal(upsample_2x_nhwc(nhwc), want.permute(0, 2, 3, 1))
        # a channel slice (the top-down path's addends) as well
        assert torch.equal(upsample_2x_nhwc(nhwc[..., 1:]),
                           want.permute(0, 2, 3, 1)[..., 1:])
