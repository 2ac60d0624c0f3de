"""The hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). Run them on a GPU machine (which needs no JAX: ``--noconftest``
skips tests/conftest.py, whose JAX set-up these tests do not use) with

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest

``chip_smoke.py`` runs the same comparisons at the DTU shapes.
"""
import pytest
import torch
import torch.nn.functional as F

from mdfnet_tpu.config import ModelConfig
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.ops.cuda import (aggregate_kernel, conv_kernel,
                                       conv_vjp, exact_cuda_math,
                                       splat_kernel, warp_kernel)
from mdfnet_tpu_torch.ops.warp import homography_warp_train

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ci,co", [(32, 16), (64, 32), (16, 8)])
def test_trconv3d(dtype, ci, co):
    x = torch.randn(1, 3, 5, 7, ci).cuda().to(dtype)
    w = (torch.randn(ci, co, 3, 3, 3) * 0.1).cuda().to(dtype)
    sc, off = torch.rand(co).cuda() + 0.5, torch.randn(co).cuda() * 0.1
    skip = torch.randn(1, 6, 10, 14, co).cuda().to(dtype)
    _agree(lambda p: conv_kernel.trconv3d_bn_act(x, w, sc, off,
                                                 residual=skip, plain=p),
           dtype)


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_with_residuals_and_stride2_tail(dtype):
    x = torch.randn(2, 19, 29, 8).cuda().to(dtype)
    ws = [(torch.randn(8, 8, 3, 3) * 0.2).cuda().to(dtype) for _ in range(3)]
    ws.append((torch.randn(16, 8, 5, 5) * 0.1).cuda().to(dtype))
    ones = torch.ones(8).cuda()
    scales = [ones, ones, ones * 0.1, torch.rand(16).cuda() + 0.5]
    offsets = [torch.randn(s.shape[0]).cuda() * 0.1 for s in scales]
    before = conv_kernel.LAUNCHES["conv2d_chain"]
    _agree(lambda p: conv_kernel.conv2d_chain(
        x, ws, scales, offsets, relu_flags=(True, True, False, True),
        residuals=(None, None, 0, None), final_stride=2, plain=p), dtype)
    assert conv_kernel.LAUNCHES["conv2d_chain"] == before + 4


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
@pytest.mark.parametrize("c,stress", [(8, False), (32, False), (16, True)])
def test_splat_2d_and_its_determinism(dtype, c, stress):
    """f32 output; two launches on the same inputs are bit-identical."""
    h, w, d, v = 20, 36, 6, 4
    x, y = _sweep(h, w, d, v, stress)
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
    assert err <= REL_TOL[torch.float32] * ref.abs().max().item()


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
            assert moved == ({counter} if counter else set())
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
            if name != "conv2d_chain":
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
