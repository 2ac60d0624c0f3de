"""The hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). Run them on a GPU machine (which needs no JAX: ``--noconftest``
skips tests/conftest.py, whose JAX set-up these tests do not use) with

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest

``chip_smoke.py`` runs the same comparisons at the DTU shapes.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.models.conv_routes import eval_conv_routes
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.ops.aggregate_train import rowsweep_aggregate_train
from mdfnet_tpu_torch.ops.cuda import (aggregate_kernel, conv_kernel,
                                       conv_vjp, exact_cuda_math,
                                       splat_kernel, warp_kernel)
from mdfnet_tpu_torch.ops.warp import (homography_warp_train,
                                       sweep_sample_coords)

pytestmark = pytest.mark.cuda

# |kernel - plain| / max|plain|: f32 differs by summation order; a bf16
# output may differ by one bf16 rounding step of the value
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.manual_seed(0)


def _agree(fn, dtype):
    got, ref = fn(False), fn(True)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * max(ref.float().abs().max().item(), 1e-6)


def _cameras(h, w, v=4, yaw=0.0):
    """Cameras translated along x; ``yaw`` (radians) also turns view i by
    i * yaw about the y axis (strong perspective between views)."""
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(v, 1, 1)
    e[:, 0, 3] = -torch.arange(v) * 12.0
    for i in range(v):
        c, s = torch.cos(torch.tensor(i * yaw)), torch.sin(torch.tensor(i * yaw))
        e[i, 0, 0], e[i, 0, 2], e[i, 2, 0], e[i, 2, 2] = c, s, -s, c
    return geometry.projection_matrices(k.repeat(1, v, 1, 1).cuda(),
                                        e[None].cuda(), stage=3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,per_pixel,stress", [(8, True, False),
                                                (16, True, False),
                                                (32, False, False),
                                                (8, False, True)])
def test_rowsweep_aggregate(dtype, g, per_pixel, stress):
    """``stress``: 20 degrees between views and planes from 40 to 5000 —
    cameras where the TPU kernel's source window would not hold."""
    b, s, d, h, w = 1, 3, 6, 20, 36
    ref_proj, src_projs = _cameras(h, w, s + 1, yaw=0.35 if stress else 0.0)
    hyp = torch.linspace(*((40, 5000) if stress else (425, 935)), d) \
        .reshape(1, d, 1, 1)
    if per_pixel:
        hyp = hyp + torch.rand(1, d, h, w) * 30
    args = (torch.randn(b, s, h, w, g).cuda().to(dtype),
            torch.randn(b, h, w, g).cuda().to(dtype), src_projs, ref_proj,
            hyp.cuda(), torch.randn(g).cuda() * 0.3,
            *(torch.tensor(v).cuda() for v in (0.9, 0.1, 1.2, -0.2)))
    before = aggregate_kernel.LAUNCHES["rowsweep_aggregate"]
    _agree(lambda p: aggregate_kernel.rowsweep_aggregate(*args, plain=p),
           dtype)
    assert aggregate_kernel.LAUNCHES["rowsweep_aggregate"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("planes", ["uniform", "per-pixel", "stress"])
@pytest.mark.parametrize("g", [8, 16, 32])
def test_rowsweep_aggregate_lane_groups(dtype, g, planes):
    """K1's lane groups (G / 8 lanes a pixel) at extents that its pixel
    tiles (128 / (G / 8) pixels of the flattened H x W) and plane runs (8)
    do not divide, 2 items: uniform and per-pixel planes, and the stress
    cameras (20 degrees between views, planes from 40 to 5000)."""
    args = _aggregate_args(dtype, g, planes == "per-pixel",
                           planes == "stress", d=11, h=13, w=37)
    plan = aggregate_kernel.aggregate_plan(2, 11, 13, 37, g)
    assert (13 * 37) % plan.pixels and 11 % plan.planes
    sc = [torch.tensor(v).cuda() for v in (0.9, 0.1, 1.2, -0.2)]
    before = aggregate_kernel.LAUNCHES["rowsweep_aggregate"]
    _agree(lambda p: aggregate_kernel.rowsweep_aggregate(*args, *sc, plain=p),
           dtype)
    assert aggregate_kernel.LAUNCHES["rowsweep_aggregate"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,per_pixel", [(32, False), (16, True), (8, False)])
def test_rowsweep_aggregate_on_a_band(dtype, g, per_pixel):
    """K1 with a reference band (spatial sharding): H rows from row0 of the
    Hs-row sources, Hs != H, against its plain version; in f32 each band
    gives the full launch's rows bit for bit (the same coordinates)."""
    b, s, d, hs, w = 1, 3, 6, 24, 36
    ref_proj, src_projs = _cameras(hs, w, s + 1)
    hyp = torch.linspace(425, 935, d).reshape(1, d, 1, 1)
    if per_pixel:
        hyp = hyp + torch.rand(1, d, hs, w) * 30
    src = torch.randn(b, s, hs, w, g).cuda().to(dtype)
    ref = torch.randn(b, hs, w, g).cuda().to(dtype)
    dw = (torch.randn(g).cuda() * 0.3,
          *(torch.tensor(v).cuda() for v in (0.9, 0.1, 1.2, -0.2)))
    hyp = hyp.cuda()
    full = aggregate_kernel.rowsweep_aggregate(src, ref, src_projs, ref_proj,
                                               hyp, *dw)
    for row0, h in ((0, 8), (8, 8), (16, 8), (4, 12)):
        rows = slice(row0, row0 + h)
        band_hyp = hyp[:, :, rows] if per_pixel else hyp
        before = aggregate_kernel.LAUNCHES["rowsweep_aggregate"]
        _agree(lambda p: aggregate_kernel.rowsweep_aggregate(
            src, ref[:, rows].contiguous(), src_projs, ref_proj,
            band_hyp.contiguous(), *dw, row0=row0, plain=p), dtype)
        assert aggregate_kernel.LAUNCHES["rowsweep_aggregate"] == before + 1
        if dtype == torch.float32:
            band = aggregate_kernel.rowsweep_aggregate(
                src, ref[:, rows].contiguous(), src_projs, ref_proj,
                band_hyp.contiguous(), *dw, row0=row0)
            assert torch.equal(band, full[:, :, rows]), row0


def test_rowsweep_aggregate_rejects_unsupported_groups():
    ref_proj, src_projs = _cameras(8, 16, 2)
    args = (torch.randn(1, 1, 8, 16, 12).cuda(),
            torch.randn(1, 8, 16, 12).cuda(), src_projs, ref_proj,
            torch.rand(1, 3, 1, 1).cuda() + 500, torch.randn(12).cuda(),
            *(torch.tensor(1.0).cuda(),) * 4)
    with pytest.raises(ValueError):
        aggregate_kernel.rowsweep_aggregate(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride,ci,co", [(1, 16, 8), (2, 8, 16), (1, 8, 1),
                                          (1, 64, 32)])
def test_conv3d(dtype, stride, ci, co):
    x = torch.randn(1, 6, 10, 14, ci).cuda().to(dtype)
    w = (torch.randn(co, ci, 3, 3, 3) * 0.1).cuda().to(dtype)
    sc, off = torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.1
    _agree(lambda p: conv_kernel.conv3d_bn_act(x, w, sc, off, stride=stride,
                                               plain=p), dtype)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "direct"),
                                         (torch.bfloat16, "direct"),
                                         (torch.bfloat16, "tc")])
@pytest.mark.parametrize("ci,co,shape", [
    (32, 16, (1, 3, 5, 7)), (64, 32, (1, 3, 5, 7)), (16, 8, (1, 3, 5, 7)),
    (32, 16, (2, 5, 11, 21)), (8, 8, (1, 9, 3, 10)), (16, 24, (1, 2, 9, 9))])
def test_trconv3d(dtype, ci, co, shape, route):
    """Both routes (the tc kernel takes bf16 input only); odd extents and H
    not a multiple of 8 (ragged coarse tiles, the far-end halo); each
    launch counts once, under ``conv_tc`` too on the tc route."""
    x = torch.randn(*shape, ci).cuda().to(dtype)
    w = (torch.randn(ci, co, 3, 3, 3) * 0.1).cuda().to(dtype)
    sc, off = torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.1
    skip = torch.randn(shape[0], *(2 * e for e in shape[1:]), co).cuda() \
        .to(dtype)
    assert conv_kernel.conv_route(dtype, 3, 3, 2, ci, co, True) == (
        "tc" if dtype == torch.bfloat16 else "direct")
    before = dict(conv_kernel.LAUNCHES)
    _agree(lambda p: conv_kernel.trconv3d_bn_act(
        x, w, sc, off, residual=skip, plain=p, route=route), dtype)
    assert conv_kernel.LAUNCHES["trconv3d_bn_act"] == \
        before["trconv3d_bn_act"] + 1
    assert conv_kernel.LAUNCHES["conv_tc"] == \
        before["conv_tc"] + (route == "tc")


@pytest.mark.parametrize("out", ["bf16", "f32+res"])
@pytest.mark.parametrize("ci,co", [(32, 16), (64, 32), (16, 8)])
def test_trconv_tc_matches_its_mirror(ci, co, out):
    """The tc transposed conv vs ``trconv_tc_plain`` on the packed weights,
    the plain mirror of its K order; the f32 output at the f32 tolerance."""
    x = torch.randn(2, 3, 9, 13, ci).cuda().to(torch.bfloat16)
    w = (torch.randn(ci, co, 3, 3, 3) * 0.1).cuda().to(torch.bfloat16)
    sc, off = torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.3
    out_dtype = torch.float32 if out == "f32+res" else torch.bfloat16
    res = (torch.randn(2, 6, 18, 26, co).cuda().to(out_dtype)
           if out == "f32+res" else None)
    packed = conv_kernel.pack_trconv_tc_weight(w.permute(2, 3, 4, 0, 1))
    got = conv_kernel.trconv3d_bn_act(x, w, sc, off, residual=res,
                                      out_dtype=out_dtype)
    ref = conv_kernel.trconv_tc_plain(x, packed, sc, off, relu=True,
                                      residual=res, out_dtype=out_dtype)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL[out_dtype] * ref.float().abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,stride,ci,co", [(1, 1, 16, 64), (3, 1, 3, 8),
                                            (5, 2, 8, 16), (3, 2, 16, 32),
                                            (3, 1, 8, 1)])
def test_conv2d(dtype, k, stride, ci, co):
    x = torch.randn(3, 17, 23, ci).cuda().to(dtype)
    w = (torch.randn(co, ci, k, k) * 0.2).cuda().to(dtype)
    sc, off = torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.1
    _agree(lambda p: conv_kernel.conv2d_bn_act(x, w, sc, off, stride=stride,
                                               plain=p), dtype)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "fused"),
                                         (torch.bfloat16, "layers"),
                                         (torch.float32, None)])
def test_chain_with_residuals_and_stride2_tail(dtype, route, monkeypatch):
    """bf16 on the chain kernel (the chain given a tile in CHAIN_FUSED):
    one launch; bf16 and f32 per layer: one K4 launch a layer (f32 by
    chain_route), which the chain's own counter does not count."""
    x = torch.randn(2, 19, 29, 8).cuda().to(dtype)
    ws = [(torch.randn(8, 8, 3, 3) * 0.2).cuda().to(dtype) for _ in range(3)]
    ws.append((torch.randn(16, 8, 5, 5) * 0.1).cuda().to(dtype))
    ones = torch.ones(8).cuda()
    scales = [ones, ones, ones * 0.1, torch.rand(16).cuda() + 0.5]
    offsets = [torch.randn(s.shape[0]).cuda() * 0.1 for s in scales]
    relus, res = (True, True, False, True), (None, None, 0, None)
    specs = tuple((w.shape[-1], w.shape[1], w.shape[0]) for w in ws)
    monkeypatch.setitem(conv_kernel.CHAIN_FUSED, (specs, relus, res, 2),
                        (8, 16))
    assert [(g.first, g.last) for g in conv_kernel.chain_plan(
        specs, relus, res, 2, (8, 16))] == [(0, 3)]
    before = dict(conv_kernel.LAUNCHES)
    fused = route == "fused"
    _agree(lambda p: conv_kernel.conv2d_chain(
        x, ws, scales, offsets, relu_flags=relus, residuals=res,
        final_stride=2, plain=p, route=route), dtype)
    assert conv_kernel.LAUNCHES["conv2d_chain"] == \
        before["conv2d_chain"] + (1 if fused else 0)
    assert conv_kernel.LAUNCHES["conv2d_bn_act"] == \
        before["conv2d_bn_act"] + (0 if fused else 4)


# the eval forward's chains (K5): specs (k, Ci, Co), ReLUs, residuals,
# final stride, the DTU input (N, H, W, Ci), and the final tile the chain
# kernel takes them at here (the trunk's and x2's from CHAIN_FUSED; the
# others, which the rule leaves per layer, at the tile that ran them
# fastest)
CHAINS = {
    "trunk": (((3, 3, 8), (3, 8, 8), (5, 8, 16)), (True,) * 3, (None,) * 3,
              2, (5, 1184, 1600, 3), (32, 64)),
    "x2": (((3, 16, 16),) * 2, (True,) * 2, (None,) * 2, 1, (5, 592, 800, 16),
           (16, 32)),
    "x3": (((3, 32, 32),) * 2, (True,) * 2, (None,) * 2, 1, (5, 296, 400, 32),
           (8, 16)),
    "refine": (((3, 1, 8),) + ((3, 8, 8),) * 7 + ((3, 8, 32),),
               (False,) + (True, False) * 3 + (False, False),
               (None, None, 0, None, 2, None, 4, 0, None), 1, (1, 592, 800, 1),
               (16, 16)),
}


def _chain_call(name, monkeypatch, shape=None):
    """The chain's call on random inputs (route "fused" by default), its
    tile put in CHAIN_FUSED for the test; and its plan there."""
    specs, relus, res, fs, dtu, tile = CHAINS[name]
    monkeypatch.setitem(conv_kernel.CHAIN_FUSED, CHAINS[name][:4], tile)
    shape = shape or dtu
    x = torch.randn(*shape).cuda().to(torch.bfloat16)
    ws = [(torch.randn(co, ci, k, k) / (k * ci ** 0.5)).cuda()
          .to(torch.bfloat16) for k, ci, co in specs]
    scales = [torch.rand(co).cuda() + 0.5 for _, _, co in specs]
    offsets = [torch.rand(co).cuda() * 0.2 + 0.3 for _, _, co in specs]
    return (lambda p, route="fused": conv_kernel.conv2d_chain(
        x, ws, scales, offsets, relu_flags=relus, residuals=res,
        final_stride=fs, plain=p, route=route),
        conv_kernel.chain_plan(*CHAINS[name][:4], tile))


@pytest.mark.parametrize("name", list(CHAINS))
@pytest.mark.parametrize("odd", [False, True])
def test_chain_kernel(name, odd, monkeypatch):
    """The chain kernel vs the plain chain at the DTU shape of each chain
    of the forward that it takes (whichever route the rule gives it), and
    at odd H and W (partial tiles, raw head rows copied element by
    element); one launch per segment of its plan (the trunk's one at the
    rule's tile, its stride-2 tail on the tc kernel)."""
    route = conv_kernel.chain_route(torch.bfloat16, *CHAINS[name][:4])
    assert route == ("fused" if name in ("trunk", "x2") else "layers")
    if route == "fused":
        assert conv_kernel.CHAIN_FUSED[CHAINS[name][:4]] == CHAINS[name][-1]
    shape = CHAINS[name][-2]
    if odd:
        shape = (2, 37, 53, shape[-1])
    call, plan = _chain_call(name, monkeypatch, shape)
    before = dict(conv_kernel.LAUNCHES)
    _agree(call, torch.bfloat16)
    loose = len(CHAINS[name][0]) - sum(g.last - g.first + 1 for g in plan)
    assert conv_kernel.LAUNCHES["conv2d_chain"] == \
        before["conv2d_chain"] + len(plan)
    assert conv_kernel.LAUNCHES["conv_tc"] == before["conv_tc"] + loose
    assert loose == (1 if name == "trunk" else 0)


@pytest.mark.parametrize("name", ["trunk", "refine"])
def test_chain_kernel_gives_the_same_bits_each_launch(name, monkeypatch):
    """Ten launches on the same inputs give the same bits: a wgmma reading
    a buffer before the epilogue's stores reach the async proxy would read
    stale values only some of the time."""
    call, _ = _chain_call(name, monkeypatch)
    first = call(False)
    for _ in range(9):
        assert torch.equal(call(False), first)


def test_chain_kernel_takes_what_the_layers_route_takes(monkeypatch):
    """The fused route and the per-layer route agree (both bf16 kernels),
    and forcing the fused route on a chain it does not take, or one not in
    CHAIN_FUSED, raises."""
    call, _ = _chain_call("x2", monkeypatch, (2, 29, 41, 16))
    got, ref = call(False), call(False, route="layers")
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL[torch.bfloat16] * ref.float().abs().max().item()
    x = torch.randn(1, 8, 8, 64).cuda().to(torch.bfloat16)
    w = torch.randn(64, 64, 3, 3).cuda().to(torch.bfloat16)
    one = torch.ones(64).cuda()
    with pytest.raises(ValueError):
        conv_kernel.conv2d_chain(x, [w, w], [one] * 2, [one] * 2,
                                 route="fused")
    x = x[..., :8].contiguous()
    w = w[:8, :8].contiguous()
    with pytest.raises(ValueError):
        conv_kernel.conv2d_chain(x, [w, w], [one[:8]] * 2, [one[:8]] * 2,
                                 route="fused")


def test_corenet_kernels_match_plain():
    """Small full-width forward: bf16 kernels vs the plain f32 path."""
    model = build_model(ModelConfig(compute_dtype="bfloat16"), device="cuda")
    plain = build_model(ModelConfig(), device="cuda")
    plain.load_state_dict(model.state_dict())
    h, w, v = 128, 160, 3
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(v, 1, 1)
    e[:, 0, 3] = -torch.arange(v) * 12.0
    args = (torch.rand(1, v, h, w, 3).cuda(), e[None].cuda(),
            k.repeat(1, v, 1, 1).cuda(), torch.tensor([[425.0, 935.0]]).cuda())
    out, ref = model(*args), plain(*args, plain=True)
    err = ((out["depth"] - ref["depth"]).abs() / 510.0).flatten()
    assert torch.isfinite(out["depth"]).all()
    assert err.median() <= 0.004 and err.quantile(0.95) <= 0.03


def test_rejected_call_is_not_counted():
    """A wrapper counts a launch only once its kernel launched: a call that
    fails validation raises and leaves the counter as it was."""
    x = torch.randn(1, 4, 6, 8, 16).cuda().half()      # f16: unsupported
    w = torch.randn(8, 16, 3, 3, 3).cuda().half()
    before = dict(conv_kernel.LAUNCHES)
    with pytest.raises(ValueError):
        conv_kernel.conv3d_bn_act(x, w, torch.ones(8).cuda(),
                                  torch.zeros(8).cuda())
    assert conv_kernel.LAUNCHES == before


# every (KD, K, stride, Ci, Co) class the eval and train paths route to the
# tc kernel, plus Co padded (24 -> 32) and Ci = Co = 64 with kd slabs
TC_CLASSES = [(3, 3, 1, 32, 16), (3, 3, 1, 16, 16), (3, 3, 1, 16, 32),
              (3, 3, 1, 64, 64), (3, 3, 1, 8, 8), (3, 3, 1, 8, 16),
              (3, 3, 2, 16, 32), (3, 3, 2, 32, 64), (3, 3, 2, 8, 16),
              (1, 5, 2, 16, 32), (1, 5, 2, 8, 16), (1, 3, 1, 8, 8),
              (1, 3, 1, 16, 16), (1, 3, 1, 8, 32), (1, 1, 1, 16, 64),
              (1, 1, 1, 64, 16), (1, 3, 1, 24, 24)]


def _tc_case(kd, k, stride, ci, co, out, shape):
    x = torch.randn(*shape, ci).cuda().to(torch.bfloat16)
    wshape = (co, ci) + (k,) * (3 if kd == 3 else 2)
    w = (torch.randn(wshape) * 0.1).cuda().to(torch.bfloat16)
    sc, off = torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.3
    out_dtype = torch.float32 if out == "f32+res" else torch.bfloat16
    oshape = [(e + stride - 1) // stride for e in shape[1:]]
    res = (torch.randn(shape[0], *oshape, co).cuda().to(out_dtype)
           if out != "bf16" else None)
    conv = conv_kernel.conv3d_bn_act if kd == 3 else conv_kernel.conv2d_bn_act
    # Co = 24 (padded to 32 inside the kernel) also runs without the ReLU
    return lambda p: conv(x, w, sc, off, stride=stride, relu=co != 24,
                          residual=res, out_dtype=out_dtype, plain=p)


@pytest.mark.parametrize("out", ["bf16", "bf16+res", "f32+res"])
@pytest.mark.parametrize("kd,k,stride,ci,co", TC_CLASSES)
def test_conv_tc(kd, k, stride, ci, co, out):
    """The tc kernel vs the plain conv at odd extents: ragged M blocks and
    tiles, every border, stride 2 with odd D/H/W; a residual; an f32 output
    (f32 tolerance: bf16 products are exact in f32, only the order of the
    sums differs)."""
    shape = (2, 7, 13, 19) if kd == 3 else (2, 37, 29)
    fn = _tc_case(kd, k, stride, ci, co, out, shape)
    assert conv_kernel.conv_route(torch.bfloat16, kd, k, stride, ci,
                                  co) == "tc"
    before = dict(conv_kernel.LAUNCHES)
    _agree(fn, torch.float32 if out == "f32+res" else torch.bfloat16)
    assert conv_kernel.LAUNCHES["conv_tc"] == before["conv_tc"] + 1


@pytest.mark.parametrize("kd,k,stride,ci,co", TC_CLASSES[:10])
def test_conv_tc_matches_its_mirror(kd, k, stride, ci, co):
    """The tc kernel vs ``conv_tc_plain`` on the packed weights, the plain
    mirror of its K order, both in f32 output."""
    shape = (1, 5, 11, 17) if kd == 3 else (2, 21, 19)
    x = torch.randn(*shape, ci).cuda().to(torch.bfloat16)
    w = (torch.randn((co, ci) + (k,) * (3 if kd == 3 else 2)) * 0.1).cuda()
    sc, off = torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.3
    w_kio = w.permute(*range(2, w.dim()), 1, 0)
    packed = conv_kernel.pack_tc_weight(w_kio.reshape(kd, k, k, ci, co),
                                        kd=kd, k=k, stride=stride)
    conv = conv_kernel.conv3d_bn_act if kd == 3 else conv_kernel.conv2d_bn_act
    got = conv(x, w.to(torch.bfloat16), sc, off, stride=stride,
               out_dtype=torch.float32)
    ref = conv_kernel.conv_tc_plain(x, packed, sc, off, kd=kd, k=k,
                                    stride=stride, relu=True,
                                    residual=None, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    assert err <= REL_TOL[torch.float32] * ref.abs().max().item()


def test_conv_tc_routes_and_failures():
    """The rule keeps f32 with Co > 1 and Ci = 3 on the direct kernel and
    sends Co = 1 to the co1 kernel; forcing the tc or co1 route where it
    has no tile raises before any launch, and a launch the kernel refuses
    (an N it has no instantiation for) returns an error that the wrapper's
    check raises."""
    from mdfnet_tpu_torch.ops.cuda import build
    for args in ((torch.float32, 3, 3, 1, 32, 16),
                 (torch.bfloat16, 1, 3, 1, 3, 8)):
        assert conv_kernel.conv_route(*args) == "direct"
    for args in ((torch.bfloat16, 3, 3, 1, 16, 1),
                 (torch.float32, 1, 3, 1, 8, 1)):
        assert conv_kernel.conv_route(*args) == "co1"
    before = dict(conv_kernel.LAUNCHES)
    x = torch.randn(1, 9, 9, 3).cuda().to(torch.bfloat16)
    w = torch.randn(8, 3, 3, 3).cuda().to(torch.bfloat16)
    ones, zeros = torch.ones(8).cuda(), torch.zeros(8).cuda()
    with pytest.raises(ValueError):
        conv_kernel.conv2d_bn_act(x, w, ones, zeros, route="tc")
    with pytest.raises(ValueError):
        conv_kernel.conv2d_bn_act(x.float(), w.float(), ones, zeros,
                                  route="tc")
    for wrong in (w, w[:1]):      # Co = 8; Ci = 3
        with pytest.raises(ValueError):
            conv_kernel.conv2d_bn_act(x, wrong, ones[:wrong.shape[0]],
                                      zeros[:wrong.shape[0]], route="co1")
    assert conv_kernel.LAUNCHES == before
    x8 = torch.randn(1, 9, 9, 8).cuda().to(torch.bfloat16)
    lib = build.load_library()
    y = torch.empty(1, 9, 9, 8).cuda().to(torch.bfloat16)
    err = lib.mdf_conv_tc(x8.data_ptr(), x8.data_ptr(), ones.data_ptr(),
                          zeros.data_ptr(), None, y.data_ptr(), 1, 1, 9, 9,
                          8, 1, 9, 9, 8, 24, 1, 3, 1, 1, 1, 8, 10, 10, 1,
                          x8.device.index,
                          torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError):
        build.check(err, "conv_tc")
    # the co1 kernel refuses a tile that is not its own
    x8 = x8[:, None]
    w1 = torch.randn(9 * 8).cuda()
    y1 = torch.empty(1, 1, 9, 9).cuda()
    err = lib.mdf_conv_co1(x8.data_ptr(), w1.data_ptr(), ones.data_ptr(),
                           zeros.data_ptr(), None, y1.data_ptr(), 1, 1, 9, 9,
                           8, 1, 0, 1, 16, 32, 8, 2, x8.device.index,
                           torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_eval_forward_tc_launches_follow_the_rule():
    """A small bf16 eval forward launches the tc kernel once per conv and
    transposed conv that the rule sends there (48 at the default widths,
    the backbone's three composed 1x1 convs among them),
    the co1 kernel once per conv to Co = 1 (the three ProbConvs, refine's
    tail), and the chain kernel once per launch of a fused chain (2: the
    trunk's first two layers, the 16-channel pair)."""
    model = build_model(ModelConfig(compute_dtype="bfloat16"), device="cuda")
    h, w, v = 64, 96, 3
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(v, 1, 1)
    e[:, 0, 3] = -torch.arange(v) * 12.0
    before = dict(conv_kernel.LAUNCHES)
    model(torch.rand(1, v, h, w, 3).cuda(), e[None].cuda(),
          k.repeat(1, v, 1, 1).cuda(), torch.tensor([[425.0, 935.0]]).cuda())
    torch.cuda.synchronize()
    routes = eval_conv_routes(model)
    assert conv_kernel.LAUNCHES["conv_tc"] - before["conv_tc"] == \
        routes.count("tc") == 48
    assert conv_kernel.LAUNCHES["conv_co1"] - before["conv_co1"] == \
        routes.count("co1") == 4
    assert conv_kernel.LAUNCHES["conv2d_chain"] - before["conv2d_chain"] == \
        routes.count("chain") == 2


CO1_SHAPES = {3: (2, 5, 11, 37), 1: (2, 37, 45)}   # odd extents, 2 items


@pytest.mark.parametrize("io", ["bf16->bf16", "bf16->f32", "f32->f32"])
@pytest.mark.parametrize("kd,ci", [(3, 8), (3, 16), (3, 32), (1, 8),
                                   (1, 16), (1, 32)])
def test_conv_co1(kd, ci, io):
    """The Co = 1 kernel vs the plain conv at odd extents (ragged tiles in
    every axis), with a ReLU and a residual; every input/output dtype pair
    it takes."""
    x_dt, out_dt = [{"bf16": torch.bfloat16, "f32": torch.float32}[t]
                    for t in io.split("->")]
    shape = CO1_SHAPES[kd]
    x = torch.randn(*shape, ci).cuda().to(x_dt)
    w = (torch.randn((1, ci) + (3,) * (3 if kd == 3 else 2)) * 0.2) \
        .cuda().to(x_dt)
    sc, off = torch.rand(1).cuda() + 0.5, torch.randn(1).cuda() * 0.3
    res = torch.randn(*shape, 1).cuda().to(out_dt)
    conv = conv_kernel.conv3d_bn_act if kd == 3 else conv_kernel.conv2d_bn_act
    assert conv_kernel.conv_route(x_dt, kd, 3, 1, ci, 1) == "co1"
    before = dict(conv_kernel.LAUNCHES)
    _agree(lambda p: conv(x, w, sc, off, residual=res, out_dtype=out_dt,
                          plain=p), out_dt)
    assert conv_kernel.LAUNCHES["conv_co1"] == before["conv_co1"] + 1
    assert conv_kernel.LAUNCHES["conv_tc"] == before["conv_tc"]


@pytest.mark.parametrize("io", ["bf16->bf16", "bf16->f32", "f32->f32"])
@pytest.mark.parametrize("kd,ci", [(3, 8), (3, 16), (1, 8), (1, 16)])
def test_conv_co1_gives_the_direct_kernels_bits(kd, ci, io):
    """With Ci <= 16 the co1 kernel sums each output in the direct
    kernel's order, (kd, kh, kw, channel), and applies its epilogue term
    for term: the two outputs are equal, bit for bit (ReLU, residual).
    The f32 step gate's per-parameter bound reads a new summation order
    as a fault, so the order is held here until that bound comes from a
    spread of correct orders."""
    x_dt, out_dt = [{"bf16": torch.bfloat16, "f32": torch.float32}[t]
                    for t in io.split("->")]
    shape = CO1_SHAPES[kd]
    x = torch.randn(*shape, ci).cuda().to(x_dt)
    w = (torch.randn((1, ci) + (3,) * (3 if kd == 3 else 2)) * 0.2) \
        .cuda().to(x_dt)
    sc, off = torch.rand(1).cuda() + 0.5, torch.randn(1).cuda() * 0.3
    res = torch.randn(*shape, 1).cuda().to(out_dt)
    conv = conv_kernel.conv3d_bn_act if kd == 3 else conv_kernel.conv2d_bn_act
    got, direct = (conv(x, w, sc, off, residual=res, out_dtype=out_dt,
                        route=r) for r in ("co1", "direct"))
    torch.cuda.synchronize()
    assert torch.equal(got, direct)


@pytest.mark.parametrize("kd,ci,dtype", [(3, 64, torch.float32),
                                         (3, 64, torch.bfloat16),
                                         (1, 24, torch.float32)])
def test_conv_co1_channel_stages(kd, ci, dtype):
    """Where the tile holds fewer channels than Ci, they go through in
    stages (co1_plan): no ReLU, an f32 output, against the plain conv."""
    plan = conv_kernel.co1_plan(kd, ci, dtype.itemsize)
    assert plan.channels < ci
    shape = CO1_SHAPES[kd]
    x = torch.randn(*shape, ci).cuda().to(dtype)
    w = (torch.randn((1, ci) + (3,) * (3 if kd == 3 else 2)) * 0.1) \
        .cuda().to(dtype)
    sc, off = torch.ones(1).cuda(), torch.randn(1).cuda()
    conv = conv_kernel.conv3d_bn_act if kd == 3 else conv_kernel.conv2d_bn_act
    _agree(lambda p: conv(x, w, sc, off, relu=False, out_dtype=torch.float32,
                          plain=p), torch.float32)


def _sweep(h, w, d, v, stress):
    """(B*S images' sample coordinates x, y (S, D, H, W)) of a plane sweep
    over v - 1 sources; ``stress``: 20 degrees between views, planes 40 to
    5000."""
    ref_proj, src_projs = _cameras(h, w, v, yaw=0.35 if stress else 0.0)
    hyp = torch.linspace(*((40, 5000) if stress else (425, 935)), d)
    hyp = hyp.reshape(1, d, 1, 1).cuda()
    x, y = geometry.sweep_coordinates(
        src_projs[0], ref_proj.expand(v - 1, 4, 4),
        hyp.expand(v - 1, d, 1, 1), h, w)
    x, y = geometry.reference_grid_coords(x, y, h, w)
    return (x.reshape(v - 1, d, h, w).contiguous(),
            y.reshape(v - 1, d, h, w).contiguous())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,stress", [(8, False), (32, False), (16, True)])
def test_sample_2d(dtype, c, stress):
    h, w, d, v = 20, 36, 6, 4
    x, y = _sweep(h, w, d, v, stress)
    img = torch.randn(v - 1, h, w, c).cuda().to(dtype)
    before = warp_kernel.LAUNCHES["sample_2d"]
    _agree(lambda p: warp_kernel.sample_2d(img, x, y, plain=p), dtype)
    assert warp_kernel.LAUNCHES["sample_2d"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,d,c,per_pixel", [(148, 200, 48, 64, False),
                                               (592, 800, 8, 16, True)])
def test_sample_2d_at_the_variance_eval_shapes(dtype, h, w, d, c, per_pixel):
    """K6 as the variance aggregate's eval warp runs it: one source's
    C-channel features at DTU eval stage 0 (48 uniform planes) and stage 2
    (8 per-pixel planes)."""
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(2, 1, 1)
    e[1, 0, 3] = -12.0
    ref_proj, src_projs = geometry.projection_matrices(
        k[None].repeat(1, 2, 1, 1).cuda(), e[None].cuda(), 3, num_stages=4)
    hyp = torch.linspace(425.0, 935.0, d).reshape(1, d, 1, 1)
    if per_pixel:
        hyp = hyp + torch.rand(1, 1, h, w) * 40.0
    x, y = sweep_sample_coords(src_projs, ref_proj, hyp.cuda(), h, w)
    img = torch.randn(1, h, w, c).cuda().to(dtype)
    before = warp_kernel.LAUNCHES["sample_2d"]
    _agree(lambda p: warp_kernel.sample_2d(img, x, y, plain=p), dtype)
    assert warp_kernel.LAUNCHES["sample_2d"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("emit_diffs", [True, False])
def test_top_down_path_matches_the_plain_conv(dtype, emit_diffs):
    """The backbone's linearised top-down path at the default widths (x4,
    x3, x2 of 5 views at 1/8, 1/4, 1/2 of 128x160): three K4 launches (tc
    in bf16) with the upsampled addends as residuals, against the same
    structure on the plain conv."""
    from mdfnet_tpu_torch.models.backbone import FPN4Scales
    from mdfnet_tpu_torch.models.layers import init_parameters
    bb = FPN4Scales(emit_diffs=emit_diffs)
    init_parameters(bb, torch.Generator().manual_seed(0))
    bb = bb.cuda()
    xs = [torch.randn(5, 128 >> s, 160 >> s, c).cuda().to(dtype)
          for s, c in ((1, 16), (2, 32), (3, 64))]
    before = dict(conv_kernel.LAUNCHES)
    got = bb._top_down(*xs, plain=False)
    torch.cuda.synchronize()
    assert conv_kernel.LAUNCHES["conv2d_bn_act"] \
        - before["conv2d_bn_act"] == 3
    assert conv_kernel.LAUNCHES["conv_tc"] - before["conv_tc"] == \
        (3 if dtype == torch.bfloat16 and emit_diffs else
         2 if dtype == torch.bfloat16 else 0)
    ref = bb._top_down(*xs, plain=True)
    for g, r, c in zip(got, ref, (64, 32, 16)):
        assert g.shape[-1] == r.shape[-1] == (c // 2 if emit_diffs else c)
        err = (g.float() - r.float()).abs().max().item()
        assert err <= REL_TOL[dtype] * r.float().abs().max().item()


@pytest.mark.parametrize("fields", [
    dict(aggregate_impl="variance"), dict(hypo_impl="atv"),
    dict(refine_impl="refine1"), dict(curve_classes=(None, "gauss0",
                                                     "gauss0"))])
def test_alternative_units_on_the_kernels(fields):
    """Each alternative unit's small f32 forward on the kernels against
    the plain f32 forward (the kernels sum in other orders); the variance
    aggregate warps on K6, one launch a source a stage."""
    model = build_model(ModelConfig(**fields), device="cuda")
    h, w, v = 128, 160, 3
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(v, 1, 1)
    e[:, 0, 3] = -torch.arange(v) * 12.0
    args = (torch.rand(1, v, h, w, 3).cuda(), e[None].cuda(),
            k.repeat(1, v, 1, 1).cuda(), torch.tensor([[425.0, 935.0]]).cuda())
    before = warp_kernel.LAUNCHES["sample_2d"]
    out = model(*args)
    torch.cuda.synchronize()
    launches = warp_kernel.LAUNCHES["sample_2d"] - before
    assert launches == (3 * (v - 1) if "aggregate_impl" in fields else 0)
    ref = model(*args, plain=True)
    err = ((out["depth"] - ref["depth"]).abs() / 510.0).flatten()
    assert torch.isfinite(out["depth"]).all()
    assert err.median() <= 1e-4 and err.quantile(0.95) <= 1e-3
    assert (out["confidence"] - ref["confidence"]).abs().mean() <= 1e-4


# name -> (H, W, planes, views, channels, coordinates): the sweep of
# _sweep ("sweep", "stress"), or uniform in a box (x0, x1, y0, y1): "one
# tile" puts every sample into the first tile, so it takes many of the
# reduce's chunks and its cells hold many samples each; "outside" puts
# every coordinate outside the image (each snaps to -1: only a zero-weight
# tap at pixel (0, 0) stays in the image). "stage 0-2": the DTU train
# stages' per-image shapes.
SPLAT_CASES = {
    "c8": (20, 36, 6, 4, 8, "sweep"), "c32": (20, 36, 6, 4, 32, "sweep"),
    "stress": (20, 36, 6, 4, 16, "stress"),
    "stage 0": (64, 80, 48, 3, 32, "sweep"),
    "stage 1": (128, 160, 24, 3, 16, "sweep"),
    "stage 2": (256, 320, 8, 3, 8, "sweep"),
    "one tile": (70, 90, 40, 3, 16, (3.0, 9.0, 2.0, 5.0)),
    "outside": (20, 36, 6, 3, 8, (-40.0, -1.0, -20.0, 60.0)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(SPLAT_CASES))
def test_splat_2d_and_its_determinism(dtype, case):
    """f32 output; two launches on the same inputs are bit-identical."""
    h, w, d, v, c, coords = SPLAT_CASES[case]
    if isinstance(coords, str):
        x, y = _sweep(h, w, d, v, coords == "stress")
    else:
        x0, x1, y0, y1 = coords
        x = (torch.rand(v - 1, d, h, w) * (x1 - x0) + x0).cuda()
        y = (torch.rand(v - 1, d, h, w) * (y1 - y0) + y0).cuda()
    g = torch.randn(v - 1, d, h, w, c).cuda().to(dtype)
    before = splat_kernel.LAUNCHES["splat_2d"]
    got = splat_kernel.splat_2d(g, x, y, h, w)
    again = splat_kernel.splat_2d(g, x, y, h, w)
    ref = splat_kernel.splat_2d(g, x, y, h, w, plain=True)
    torch.cuda.synchronize()
    assert splat_kernel.LAUNCHES["splat_2d"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (v - 1, h, w, c)
    assert torch.equal(got, again)
    err = (got - ref).abs().max().item()
    assert err <= REL_TOL[torch.float32] * max(ref.abs().max().item(), 1e-6)
    if case == "outside":
        assert not got.any()


def _sequential_splat(g, x, y, h, w):
    """Each pixel's f32 sum of its in-image terms (v * fy) * fx in ascending
    (sample, tap) order, in numpy: the order and the rounding of the splat
    kernel (and of the sort-based kernel before it)."""
    import numpy as np
    f32 = np.float32
    b, c = g.shape[0], g.shape[-1]
    gf = g.float().cpu().numpy().reshape(-1, c)
    xs, ys = x.cpu().numpy().reshape(-1), y.cpu().numpy().reshape(-1)
    n = xs.size // b
    xs = np.where((xs > -1) & (xs < w), xs, f32(-1)).astype(f32)
    ys = np.where((ys > -1) & (ys < h), ys, f32(-1)).astype(f32)
    x0, y0 = np.floor(xs), np.floor(ys)
    wx, wy = (xs - x0).astype(f32), (ys - y0).astype(f32)
    out = np.zeros((b, h, w, c), f32)
    with np.errstate(invalid="ignore"):
        for i in range(xs.size):
            for k in range(4):
                xi, yi = int(x0[i]) + (k & 1), int(y0[i]) + (k >> 1)
                if 0 <= xi < w and 0 <= yi < h:
                    fx = wx[i] if k & 1 else f32(1) - wx[i]
                    fy = wy[i] if k >> 1 else f32(1) - wy[i]
                    out[i // n, yi, xi] += (gf[i] * fy).astype(f32) * fx
    return torch.from_numpy(out)


@pytest.mark.parametrize("c,stress", [(8, False), (32, True), (16, False)])
def test_splat_2d_sums_in_sample_order(c, stress):
    """The kernel's f32 output is, bit for bit, each pixel's sequential sum
    in ascending sample order; a sample snapped outside the image whose
    value is infinite or NaN leaves NaN at its in-image taps, as that sum
    does."""
    h, w, d, v = 20, 36, 6, 3
    x, y = _sweep(h, w, d, v, stress)
    x[0, 0, :, :4] = -3.0                     # snapped samples
    g = torch.randn(v - 1, d, h, w, c).cuda()
    g[0, 0, :, :4:3, 1] = float("inf")
    g[1, 2, 5, 7, 0] = float("nan")
    got = splat_kernel.splat_2d(g, x, y, h, w).cpu()
    want = _sequential_splat(g, x, y, h, w)
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().any()
    ok = ~want.isnan()
    assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))


def test_warp_train_backward_is_the_splat():
    """homography_warp_train: forward on K6, backward on K7, gradient vs
    autodiff of the plain gather on the card."""
    h, w, d, v = 16, 24, 5, 3
    ref_proj, src_projs = _cameras(h, w, v)
    hyp = torch.linspace(425, 935, d).reshape(1, d, 1, 1).cuda()
    feats = torch.randn(1, v - 1, h, w, 8).cuda()
    g = torch.randn(1, v - 1, d, h, w, 8).cuda()
    grads = []
    for plain in (False, True):
        f = feats.clone().requires_grad_(True)
        homography_warp_train(f, src_projs, ref_proj, hyp,
                              plain=plain).backward(g)
        grads.append(f.grad)
    err = (grads[0] - grads[1]).abs().max().item()
    assert err <= REL_TOL[torch.float32] * grads[1].abs().max().item()


def _plain_conv(kind, stride):
    """Plain autograd on the plain f32 conv (channels-last in and out)."""
    def run(x, w):
        xf, wf = x.float().movedim(-1, 1), w.float()
        if kind == "trconv3d":
            y = F.conv_transpose3d(xf, wf, stride=2, padding=1,
                                   output_padding=1)
        else:
            conv = F.conv3d if kind == "conv3d" else F.conv2d
            y = conv(xf, wf, stride=stride, padding=wf.shape[-1] // 2)
        return y.movedim(1, -1)
    return run


def _kernel_conv(kind, stride):
    if kind == "conv3d":
        return lambda x, w: conv_vjp.conv3d_train(x, w, stride)
    if kind == "trconv3d":
        return conv_vjp.trconv3d_train
    return lambda x, w: conv_vjp.conv2d_train(x, w, stride)


def _dgrad_counters(kind, stride, wshape, dtype, counter):
    """The counters an input gradient moves: its ``*_dgrad`` counter, and
    ``conv_tc`` where the rule sends its conv there (a stride-1 conv's input
    gradient is a conv from Co to Ci; the transposed conv's a stride-2 conv
    from its Co to its Ci; a stride-2 conv3d's is the transposed conv)."""
    if counter is None:
        return set()
    if kind == "trconv3d":
        conv = (3, 3, 2, wshape[1], wshape[0])
    elif stride == 1:
        conv = (3 if kind == "conv3d" else 1, wshape[-1], 1, wshape[0],
                wshape[1])
    else:   # the conv's (Co, Ci) weight read as the transposed conv's
        conv = (3, 3, 2, wshape[0], wshape[1], True)
    tc = conv_kernel.conv_route(dtype, *conv) == "tc"
    return {counter} | ({"conv_tc"} if tc else set())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,stride,xshape,wshape,counter", [
    ("conv3d", 1, (2, 6, 10, 14, 16), (8, 16, 3, 3, 3), "conv3d_dgrad"),
    ("conv3d", 2, (2, 5, 9, 13, 8), (16, 8, 3, 3, 3), "conv3d_dgrad"),
    ("conv3d", 1, (1, 6, 8, 10, 8), (1, 8, 3, 3, 3), "conv3d_dgrad"),
    ("trconv3d", 2, (2, 3, 5, 7, 32), (32, 16, 3, 3, 3), "trconv3d_dgrad"),
    ("conv2d", 1, (3, 17, 23, 8), (8, 8, 3, 3), "conv2d_dgrad"),
    ("conv2d", 1, (3, 17, 23, 16), (64, 16, 1, 1), "conv2d_dgrad"),
    ("conv2d", 2, (3, 17, 23, 8), (16, 8, 5, 5), None),
    ("conv2d", 1, (2, 12, 16, 8), (1, 8, 3, 3), "conv2d_dgrad")])
def test_conv_train_grads(dtype, kind, stride, xshape, wshape, counter):
    """Each K8 Function's output, d_input and d_weight vs plain autograd on
    the plain f32 conv; the stride-2 5x5 conv2d's d_input is a library
    call, so no kernel counter moves for it."""
    exact_cuda_math()
    x = torch.randn(xshape).cuda().to(dtype)
    w = (torch.randn(wshape) * 0.1).cuda().to(dtype)
    results = []
    for fn in (_kernel_conv(kind, stride), _plain_conv(kind, stride)):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xg, wg)
        if not results:
            before = dict(conv_kernel.LAUNCHES)
            g = torch.randn(y.shape).cuda()
        y.backward(g.to(y.dtype))
        results.append((y, xg.grad, wg.grad))
        if len(results) == 1:
            moved = {k for k, n in conv_kernel.LAUNCHES.items()
                     if n != before[k]}
            assert moved == _dgrad_counters(kind, stride, wshape, dtype,
                                            counter)
    torch.cuda.synchronize()
    for got, ref in zip(*results):
        assert got.shape == ref.shape and got.dtype == dtype
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= REL_TOL[dtype] * ref.float().abs().max().item()


def test_train_step_on_the_kernels():
    """A small full-width bf16 train step: every kernel of the step
    launches, and the loss and gradients are finite."""
    from mdfnet_tpu_torch.train_lib import loss_and_grads
    model = build_model(ModelConfig(compute_dtype="bfloat16"),
                        device="cuda").requires_grad_(True)
    h, w, v = 64, 96, 3
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(v, 1, 1)
    e[:, 0, 3] = -torch.arange(v) * 12.0
    gt = torch.rand(2, h, w).cuda() * 400 + 450
    batch = {"imgs": torch.rand(2, v, h, w, 3).cuda(),
             "extrinsics": e[None].repeat(2, 1, 1, 1).cuda(),
             "intrinsics": k.repeat(2, v, 1, 1).cuda(),
             "depth_range": torch.tensor([[425.0, 935.0]] * 2).cuda(),
             "ref_depths": {str(s): gt[:, ::2 ** s, ::2 ** s]
                            for s in range(4)}}
    counters = (warp_kernel.LAUNCHES, splat_kernel.LAUNCHES,
                conv_kernel.LAUNCHES)
    before = [dict(c) for c in counters]
    loss = loss_and_grads(model, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    for c, b in zip(counters, before):
        for name in c:
            # the chain runs in eval only; no model path runs the pair
            if name not in ("conv2d_chain", "conv3d_pair_bn_act"):
                assert c[name] > b[name], name


def test_rejected_train_kernel_calls_are_not_counted():
    before = (dict(warp_kernel.LAUNCHES), dict(splat_kernel.LAUNCHES))
    img = torch.randn(1, 4, 6, 12).cuda()           # C = 12: not 8-aligned
    x = torch.rand(1, 2, 3).cuda()
    with pytest.raises(ValueError):
        warp_kernel.sample_2d(img, x, x)
    with pytest.raises(ValueError):
        splat_kernel.splat_2d(torch.randn(1, 1, 2, 3, 12).cuda(), x[:, None],
                              x[:, None], 4, 6)
    assert (dict(warp_kernel.LAUNCHES), dict(splat_kernel.LAUNCHES)) == before


def _aggregate_args(dtype, g, per_pixel, stress, b=2, s=3, d=6, h=20, w=36,
                    yaw=None):
    """(src diffs, ref diffs, src_projs, ref_proj, hypotheses, k0) on the
    card for a batch of b items (the same cameras); ``stress``: planes from
    40 to 5000 and, unless ``yaw`` is given, 20 degrees between views."""
    if yaw is None:
        yaw = 0.35 if stress else 0.0
    ref_proj, src_projs = _cameras(h, w, s + 1, yaw=yaw)
    hyp = torch.linspace(*((40, 5000) if stress else (425, 935)), d) \
        .reshape(1, d, 1, 1).repeat(b, 1, 1, 1)
    if per_pixel:
        hyp = hyp + torch.rand(b, d, h, w) * 30
    return (torch.randn(b, s, h, w, g).cuda().to(dtype),
            torch.randn(b, h, w, g).cuda().to(dtype),
            src_projs.expand(b, s, 4, 4).contiguous(),
            ref_proj.expand(b, 4, 4).contiguous(), hyp.cuda(),
            torch.randn(g).cuda() * 0.3)


def _stats_twice_and_plain(args):
    """The stats kernel twice (bit-identical) and within REL_TOL of its plain
    version (the f32 field of each voxel differs by summation order only)."""
    got = aggregate_kernel.rowsweep_stats(*args)
    again = aggregate_kernel.rowsweep_stats(*args)
    ref = aggregate_kernel.rowsweep_stats(*args, plain=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert torch.equal(got, again)
    err = (got - ref).abs().max().item()
    assert err <= REL_TOL[torch.float32] * ref.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,per_pixel,stress", [(8, True, False),
                                                (32, False, False),
                                                (16, False, True)])
def test_rowsweep_stats_and_its_determinism(dtype, g, per_pixel, stress):
    """f64 sums of the batch's field vs the plain version; two launches
    bit-identical."""
    args = _aggregate_args(dtype, g, per_pixel, stress)
    before = aggregate_kernel.LAUNCHES["rowsweep_stats"]
    assert aggregate_kernel.rowsweep_stats(*args).shape == (3, 2)
    assert aggregate_kernel.LAUNCHES["rowsweep_stats"] == before + 1
    _stats_twice_and_plain(args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,d,h,w", [(8, 1, 13, 37), (16, 3, 13, 37),
                                     (32, 5, 13, 37), (32, 3, 3, 70)])
def test_rowsweep_stats_at_extents_its_tiles_do_not_divide(dtype, g, d, h, w):
    """The stats kernel's plan (stats_plan) where H x W is not a multiple of
    a block's pixels, D = 1, 3 or 5, on the stress cameras."""
    plan = aggregate_kernel.stats_plan(2, d, h, w, g)
    assert (h * w) % plan.pixels
    _stats_twice_and_plain(_aggregate_args(dtype, g, False, True, d=d, h=h,
                                           w=w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rowsweep_stats_stage0_sources_partly_out_of_view(dtype):
    """DTU train stage 0 (4 items, 4 sources, 48 planes, 64 x 80, G = 32),
    planes from 40 to 5000 and view i turned by 0.1 i radians, so that 18-68%
    of each source's samples fall outside its image."""
    b, s, d, h, w = 4, 4, 48, 64, 80
    args = _aggregate_args(dtype, 32, False, True, b=b, s=s, d=d, h=h, w=w,
                           yaw=0.1)
    x, y = sweep_sample_coords(args[2], args[3], args[4], h, w)
    outside = ((x <= -1) | (x >= w) | (y <= -1) | (y >= h)).float()
    share = outside.reshape(b, s, -1).mean(dim=(0, 2))     # per source
    assert ((share > 0.05) & (share < 0.95)).all(), share
    _stats_twice_and_plain(args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [8, 32])
def test_saturated_sigmoids_take_the_division(dtype, g):
    """Pair differences scaled by 150: many samples below -87.3, whose
    sigmoid denominators reach 2^126 or overflow to inf, so the lane's
    sigmoids take the division (common.cuh sigmoid_n); the stats kernel and
    K1's train launch against their plain versions."""
    args = list(_aggregate_args(dtype, g, True, False))
    args[0] = (args[0].float() * 150.0).to(dtype)
    bn = (torch.rand(3).cuda() + 0.5, torch.randn(3).cuda() * 0.2,
          torch.tensor(1.2).cuda(), torch.tensor(-0.2).cuda())
    assert (args[0].float() < -87.4).float().mean() > 0.2
    _stats_twice_and_plain(args)
    got = aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn)
    ref = aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn,
                                                        plain=True)
    for a, r in zip(got, ref):
        err = (a - r).abs().max().item()
        assert err <= REL_TOL[torch.float32] * r.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [8, 32])
def test_rowsweep_stats_sum_k1s_own_field(dtype, g):
    """B = 1, D = 1, a 16 x 16 image: the stats kernel's sums within 1e-12
    (of the sum of magnitudes) of the f64 sums of the field that K1's train
    instantiation computes.
    K1 gives its similarities exactly for one source with k1 = b1 = 0 (every
    weight sigmoid(0) = 0.5, so its volume is 0.5 sim / 0.5); the field is
    then their k0 . sim in channel order, one f32 FMA a term (an f64
    product and sum rounded to f32). A field that differs from K1's by one
    f32 rounding in a voxel reads ~1e-8 here."""
    b, s, h, w = 1, 3, 16, 16
    args = _aggregate_args(dtype, g, False, False, b=b, s=s, d=1, h=h, w=w)
    got = aggregate_kernel.rowsweep_stats(*args).cpu()
    k0 = args[5].cpu().double().numpy()
    one, zero = torch.ones(1).cuda(), torch.zeros(1).cuda()
    for v in range(s):
        sim, _ = aggregate_kernel.rowsweep_aggregate_with_wsum(
            args[0][:, v:v + 1].contiguous(), args[1],
            args[2][:, v:v + 1].contiguous(), *args[3:6], one, zero,
            torch.tensor(0.0).cuda(), torch.tensor(0.0).cuda())
        sim = sim.cpu().double().numpy()
        field = np.zeros(sim.shape[:-1], np.float32)
        for c in range(g):
            field = (sim[..., c] * k0[c] + field).astype(np.float32)
        x = field.astype(np.float64).ravel()
        for j, vals in enumerate((x, x * x)):
            exact = math.fsum(vals.tolist())
            scale = math.fsum(np.abs(vals).tolist())
            assert abs(got[v, j].item() - exact) <= 1e-12 * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,per_pixel,stress", [(8, True, False),
                                                (32, False, False),
                                                (16, False, True)])
def test_rowsweep_aggregate_with_wsum(dtype, g, per_pixel, stress):
    """K1's train instantiation: a per-view affine, the weight sum too."""
    args = _aggregate_args(dtype, g, per_pixel, stress)
    bn = (torch.rand(3).cuda() + 0.5, torch.randn(3).cuda() * 0.2,
          torch.tensor(1.2).cuda(), torch.tensor(-0.2).cuda())
    before = aggregate_kernel.LAUNCHES["rowsweep_aggregate_with_wsum"]
    got = aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn)
    ref = aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn,
                                                        plain=True)
    torch.cuda.synchronize()
    assert aggregate_kernel.LAUNCHES["rowsweep_aggregate_with_wsum"] == \
        before + 1
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype == torch.float32
        err = (a - r).abs().max().item()
        assert err <= REL_TOL[torch.float32] * r.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [8, 16, 32])
def test_rowsweep_aggregate_with_wsum_lane_groups(dtype, g):
    """K1's train instantiation at extents that its tiles and plane runs
    do not divide, on the stress cameras."""
    args = _aggregate_args(dtype, g, False, True, d=11, h=13, w=37)
    bn = (torch.rand(3).cuda() + 0.5, torch.randn(3).cuda() * 0.2,
          torch.tensor(1.2).cuda(), torch.tensor(-0.2).cuda())
    got = aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn)
    ref = aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn,
                                                        plain=True)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype == torch.float32
        err = (a - r).abs().max().item()
        assert err <= REL_TOL[torch.float32] * r.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_train_aggregate_gradients(dtype):
    """The fused train aggregate on the kernels vs on the plain versions:
    volume, statistics and every gradient; the four kernels launch."""
    args = _aggregate_args(dtype, 8, True, False)
    params = [torch.randn(8).cuda() * 0.3, torch.tensor([1.1]).cuda(),
              torch.tensor([0.1]).cuda(), torch.tensor(1.2).cuda(),
              torch.tensor(-0.2).cuda()]
    g_vol = torch.randn(2, 6, 20, 36, 8).cuda()
    counters = (aggregate_kernel.LAUNCHES, warp_kernel.LAUNCHES,
                splat_kernel.LAUNCHES)
    results = []
    for plain in (False, True):
        src, ref = (t.clone().requires_grad_(True) for t in args[:2])
        k0 = args[5].clone().requires_grad_(True)
        ps = [p.clone().requires_grad_(True) for p in params[1:]]
        before = [dict(c) for c in counters]
        vol, stats = rowsweep_aggregate_train(src, ref, *args[2:5], k0, *ps,
                                              plain=plain)
        vol.backward(g_vol)
        if not plain:
            moved = {k for c, b in zip(counters, before) for k in c
                     if c[k] > b[k]}
            assert {"rowsweep_stats", "rowsweep_aggregate_with_wsum",
                    "sample_2d", "splat_2d"} <= moved
        results.append([vol, stats, src.grad, ref.grad, k0.grad]
                       + [p.grad for p in ps])
    torch.cuda.synchronize()
    for got, want in zip(*results):
        assert got.shape == want.shape and got.dtype == want.dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-3 * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,ci,cm,co", [((1, 5, 11, 19), 32, 16, 16),
                                            ((2, 3, 9, 17), 8, 8, 3),
                                            ((1, 4, 6, 20), 64, 64, 64),
                                            ((1, 3, 5, 7), 3, 8, 1)])
def test_conv3d_pair(dtype, shape, ci, cm, co):
    """The pair kernel vs two chained plain convs, at odd extents (partial
    tiles), Ci not a multiple of 8 and Co < 8."""
    x = torch.randn(*shape, ci).cuda().to(dtype)
    w1 = (torch.randn(cm, ci, 3, 3, 3) * 0.1).cuda().to(dtype)
    w2 = (torch.randn(co, cm, 3, 3, 3) * 0.1).cuda().to(dtype)
    e1 = (torch.rand(cm).cuda() + 0.5, torch.randn(cm).cuda() * 0.3)
    e2 = (torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.1)
    before = conv_kernel.LAUNCHES["conv3d_pair_bn_act"]
    _agree(lambda p: conv_kernel.conv3d_pair_bn_act(x, w1, *e1, w2, *e2,
                                                    plain=p), dtype)
    assert conv_kernel.LAUNCHES["conv3d_pair_bn_act"] == before + 1


def test_fused_train_step_on_the_kernels():
    """A small full-width f32 step with warp_impl="fused": the kernels vs the
    plain versions on the card."""
    from mdfnet_tpu_torch.train_lib import loss_and_grads
    h, w, v = 64, 96, 3
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(v, 1, 1)
    e[:, 0, 3] = -torch.arange(v) * 12.0
    gt = torch.rand(2, h, w).cuda() * 400 + 450
    batch = {"imgs": torch.rand(2, v, h, w, 3).cuda(),
             "extrinsics": e[None].repeat(2, 1, 1, 1).cuda(),
             "intrinsics": k.repeat(2, v, 1, 1).cuda(),
             "depth_range": torch.tensor([[425.0, 935.0]] * 2).cuda(),
             "ref_depths": {str(s): gt[:, ::2 ** s, ::2 ** s]
                            for s in range(4)}}
    losses, grads = [], []
    for plain in (False, True):
        model = build_model(ModelConfig(warp_impl="fused"),
                            device="cuda").requires_grad_(True)
        losses.append(float(loss_and_grads(model, batch, plain=plain)))
        grads.append(torch.cat([p.grad.flatten()
                                for p in model.parameters()]))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    cos = grads[0] @ grads[1] / (grads[0].norm() * grads[1].norm())
    assert cos > 0.999


# ----------------------------------- the vector aggregate at C/G != 2

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,d,c,per_pixel", [(64, 80, 48, 64, False),
                                               (256, 320, 8, 16, True)])
def test_sample_and_splat_at_the_groups_train_shapes(dtype, h, w, d, c,
                                                     per_pixel):
    """K6 and K7 as the C/G = 4 train aggregate runs them
    (ModelConfig(ngroups=(16, 8, 4)) at DTU train): one source's C = 2G
    channels of 4 items a launch, stage 0 (48 uniform planes, C = 64) and
    stage 2 (8 per-pixel planes, C = 16), against their plain versions;
    K7 twice with the same bits."""
    b = 4
    k = torch.tensor([[1.8 * w, 0, w / 2], [0, 1.8 * w, h / 2], [0, 0, 1]])
    e = torch.eye(4).repeat(2, 1, 1)
    e[1, 0, 3] = -12.0
    ref_proj, src_projs = geometry.projection_matrices(
        k[None].repeat(b, 2, 1, 1).cuda(), e[None].repeat(b, 1, 1, 1).cuda(),
        3, num_stages=4)
    hyp = torch.linspace(425.0, 935.0, d).reshape(1, d, 1, 1).repeat(
        b, 1, 1, 1)
    if per_pixel:
        hyp = hyp + torch.rand(b, 1, h, w) * 40.0
    x, y = sweep_sample_coords(src_projs, ref_proj, hyp.cuda(), h, w)
    img = torch.randn(b, h, w, c).cuda().to(dtype)
    g = torch.randn(b, d, h, w, c).cuda().to(dtype)
    before = (warp_kernel.LAUNCHES["sample_2d"],
              splat_kernel.LAUNCHES["splat_2d"])
    _agree(lambda p: warp_kernel.sample_2d(img, x, y, plain=p), dtype)
    got = splat_kernel.splat_2d(g, x, y, h, w)
    again = splat_kernel.splat_2d(g, x, y, h, w)
    ref = splat_kernel.splat_2d(g, x, y, h, w, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got - ref).abs().max().item()
    assert err <= REL_TOL[torch.float32] * ref.abs().max().item()
    assert (warp_kernel.LAUNCHES["sample_2d"],
            splat_kernel.LAUNCHES["splat_2d"]) == (before[0] + 1,
                                                   before[1] + 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_groups_aggregate_on_the_card(dtype):
    """VectorAggregate at C/G = 4 on the card: the eval volume on K6 and
    the train volume and the features' gradient (K6 forward, K7 backward;
    in f32 also DepthWeight's) against the plain versions; 2 sources, 2
    items."""
    from mdfnet_tpu_torch.models.aggregate import VectorAggregate
    from mdfnet_tpu_torch.models.layers import init_parameters
    b, v, h, w, d, g = 2, 3, 24, 40, 6, 4
    agg = VectorAggregate(g)
    init_parameters(agg, torch.Generator().manual_seed(0))
    agg = agg.cuda()
    ref_proj, src_projs = _cameras(h, w, v)
    ref_proj, src_projs = ref_proj.repeat(b, 1, 1), src_projs.repeat(
        b, 1, 1, 1)
    hyp = torch.linspace(425, 935, d).reshape(1, d, 1, 1).repeat(
        b, 1, 1, 1).cuda()
    feats = torch.randn(b, v, h, w, 4 * g).cuda().to(dtype)
    before = warp_kernel.LAUNCHES["sample_2d"]
    with torch.no_grad():
        got = agg(feats, ref_proj, src_projs, hyp)
        ref = agg(feats, ref_proj, src_projs, hyp, plain=True)
    assert warp_kernel.LAUNCHES["sample_2d"] == before + v - 1
    assert got.shape == (b, d, h, w, g) and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= REL_TOL[dtype]
    ct = torch.randn(b, d, h, w, g).cuda()
    out = []
    for plain in (False, True):
        agg.zero_grad()
        f = feats.clone().requires_grad_(True)
        vol = agg(f, ref_proj, src_projs, hyp, plain=plain, train=True)
        (vol * ct).sum().backward()
        out.append([vol.detach(), f.grad.float()] + (
            [p.grad for p in agg.parameters()]
            if dtype == torch.float32 else []))
    for a, r in zip(*out):
        assert (a - r).abs().max().item() <= \
            REL_TOL[dtype] * max(r.abs().max().item(), 1e-6)
