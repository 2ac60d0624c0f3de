"""The hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). Run them on a GPU machine (which needs no JAX: ``--noconftest``
skips tests/conftest.py, whose JAX set-up these tests do not use) with

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest

``chip_smoke.py`` runs the same comparisons at the DTU shapes.
"""
import pytest
import torch

from mdfnet_tpu.config import ModelConfig
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.ops.cuda import aggregate_kernel, conv_kernel

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
