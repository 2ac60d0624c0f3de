"""The port's fusion functions on the card against the same functions on the
CPU. Their projections are elementwise f32 with explicit FMAs
(``geometry.fma``) and host-side camera inverses, so the card gives the
CPU's bits whatever TF32 setting is in force; masks and counts are held to
the tie rule of ``_fusion_scenes`` (at most 1e-4 of the entries may differ,
each at a tie), continuous outputs to the CPU's values.

Marked ``cuda``: they skip without a CUDA device. Run them on a GPU machine
(no JAX needed) with

    python -m pytest tests/test_torch_cuda_fusion.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from _fusion_scenes import check_ties, close, fusion_scene, near, \
    near_integer
from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.fusion import consistency_vote as vote
from mdfnet_tpu_torch.fusion import dynamic_filter as filt
from mdfnet_tpu_torch.fusion import pcd_fusion as pcd
from mdfnet_tpu_torch.fusion.view_store import pad_sources
from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d

pytestmark = pytest.mark.cuda
H, W, S = 96, 128, 10


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True   # the fusion uses none
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _inputs(seed, padded):
    d, k, e = fusion_scene(seed, nviews=S + 1, h=H, w=W, focal=120.0)
    src = [d[1:], k[1:], e[1:]]
    valid = None
    if padded:
        src, valid = pad_sources([a[:S - 3] for a in src], S)
    cpu = [torch.from_numpy(np.ascontiguousarray(a))
           for a in (d[0], k[0], e[0], *src)]
    cpu.append(None if valid is None else torch.from_numpy(valid))
    card = [None if a is None else a.cuda() for a in cpu]
    return cpu, card


def _both(fn, seed, padded):
    cpu, card = _inputs(seed, padded)
    got = [x.cpu().numpy() for x in fn(*card)]
    want = [x.numpy() for x in fn(*cpu)]
    return cpu, got, want


def _valid(cpu):
    return (np.ones(S, bool) if cpu[6] is None else cpu[6].numpy())


PADDED = pytest.mark.parametrize("padded", [False, True],
                                 ids=["unpadded", "padded"])


@PADDED
def test_geometric_consistency_on_the_card(padded):
    cpu, got, want = _both(filt.geometric_consistency, 0, padded)
    dre, xre, yre = (x.numpy() for x in filt._reproject(*cpu[:6]))
    yy, xx = np.mgrid[0:H, 0:W]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(dre - cpu[0].numpy()) / cpu[0].numpy()
    steps = np.arange(2, 11, dtype=np.float64)
    tie = ((near(np.hypot(xre - xx, yre - yy), steps / 4)
            | near(rel, steps / 1300)) & _valid(cpu)[:, None, None]).any(0)
    assert want[0].sum() > 0
    check_ties("rung counts", got[0], want[0], tie)
    check_ties("strict count", got[1], want[1], tie)
    close("depth sum", got[2], want[2], skip=tie)


@PADDED
def test_consistency_vote_on_the_card(padded):
    cpu, got, want = _both(vote.consistency_vote, 1, padded)
    xw = geometry.unproject(*(a[None] for a in cpu[:3]))
    xs, ys, dx = geometry.project(xw.expand(S, 3, H * W), *cpu[4:6])
    ds = bilinear_sample_2d(cpu[3][..., None], xs, ys, fused=True)[..., 0]
    centre = lambda m: -(m[..., :3, :3].transpose(-1, -2).double()
                         @ m[..., :3, 3:].double())
    fb = cpu[1][0, 0].double() * (centre(cpu[2])[None]
                                  - centre(cpu[5])).norm(dim=1)
    diff = (fb / dx.double() - fb / ds.double()).abs().numpy()
    xs, ys = xs.numpy(), ys.numpy()
    border = (np.minimum(np.abs(xs), np.abs(xs - W)) <= 1e-5 * W) | \
        (np.minimum(np.abs(ys), np.abs(ys - H)) <= 1e-5 * H)
    ok = _valid(cpu)[:, None]
    tie_acc = ((near(diff, [0.25]) | border) & ok).any(0)
    tie_pt = ((near_integer(xs) | near_integer(ys)) & ok).any(0)
    assert want[1].any()
    check_ties("accept", got[1], want[1], tie_acc)
    both = got[1] & want[1]
    close("voted points", got[0][both], want[0][both],
          skip=tie_pt[both, None])


@PADDED
def test_reproject_all_and_masks_on_the_card(padded):
    cpu, got, want = _both(pcd.reproject_all, 2, padded)
    world = pcd._img2world(pcd._centers(H, W), cpu[0].reshape(-1), *cpu[1:3])
    xs, ys, _ = pcd._world2img(world.expand(S, 3, H * W), *cpu[4:6])
    tie_cell = (near_integer(xs.numpy()) | near_integer(ys.numpy())
                ).reshape(S, H, W)
    check_ties("in range", got[3], want[3], tie_cell)
    for name, g, w in zip("xyd", got[:3], want[:3]):
        close(f"reprojected {name}", g, w, skip=tie_cell)
    masks = [x.cpu().numpy() for x in pcd.visibility_masks(
        cpu[0].cuda(), *(torch.from_numpy(a).cuda() for a in want))]
    masks_c = [x.numpy() for x in pcd.visibility_masks(
        cpu[0], *map(torch.from_numpy, want))]
    xr, yr, dr = (a.astype(np.float64) for a in want[:3])
    yy, xx = np.mgrid[0:H, 0:W] + 0.5
    ref = cpu[0].numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(ref - dr) / np.maximum(ref, dr)
    tie = near(np.hypot(xr - xx, yr - yy), [1.0]) | near(rel, [0.01])
    assert masks_c[1].any()
    check_ties("visibility masks", masks[0], masks_c[0], tie)
    check_ties("visibility vote", masks[1], masks_c[1], tie.any(0))
    avg = pcd.averaged_depth(cpu[0].cuda(), torch.from_numpy(want[2]).cuda(),
                             torch.from_numpy(masks_c[0]).cuda()).cpu()
    close("averaged depth", avg.numpy(), pcd.averaged_depth(
        cpu[0], torch.from_numpy(want[2]),
        torch.from_numpy(masks_c[0])).numpy())


@PADDED
def test_candidates_violations_and_zbuffer_on_the_card(padded):
    cpu, got, want = _both(pcd._candidates_and_violations, 3, padded)
    xy, d, vio, ok = want
    np.testing.assert_array_equal(got[3], ok)
    close("candidate xy", got[0][ok], xy[ok])
    close("candidate depth", got[1][ok], d[ok])
    x, y = torch.from_numpy(xy[:, 0]), torch.from_numpy(xy[:, 1])
    world = pcd._img2world(torch.stack([x, y, torch.ones_like(x)]),
                           torch.from_numpy(d), *cpu[1:3])
    tie = np.zeros(len(d), bool)
    for i in np.flatnonzero(_valid(cpu)):
        xs, ys, dz = pcd._world2img(world, cpu[4][i], cpu[5][i])
        ds, _ = pcd._nearest_sample(cpu[3][i], xs, ys)
        tie |= (near_integer(xs.numpy()) | near_integer(ys.numpy())
                | (np.abs(ds.numpy() - dz.numpy().astype(np.float64))
                   <= 1e-5 * np.abs(dz.numpy())))
    assert vio[ok].sum() > 0
    check_ties("violations", got[2][ok], vio[ok], tie[ok])

    arrays = [a.numpy() for a in cpu[:6]]
    valid = None if cpu[6] is None else cpu[6].numpy()
    times = {}
    on_card = pcd.zbuffer_fusion(*arrays, src_valid=valid, device="cuda",
                                 times=times)
    on_cpu = pcd.zbuffer_fusion(*arrays, src_valid=valid, device="cpu")
    tie_px = np.zeros((H, W), bool)
    cx = np.clip(np.floor(xy[tie & ok, 0]).astype(int), 0, W - 1)
    cy = np.clip(np.floor(xy[tie & ok, 1]).astype(int), 0, H - 1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            tie_px[np.clip(cy + dy, 0, H - 1), np.clip(cx + dx, 0, W - 1)] = 1
    assert set(times) == {"candidates", "copy", "election"}
    check_ties("elected depth", on_card, on_cpu, tie_px)


def test_projection_helpers_give_the_cpus_bits():
    rng = np.random.RandomState(4)
    m = torch.from_numpy(rng.randn(5, 4, 4).astype(np.float32))
    v = torch.from_numpy((rng.randn(5, 4, 10000) * 100).astype(np.float32))
    for a, b in ((geometry.matmul(m.cuda(), v.cuda()), geometry.matmul(m, v)),
                 (geometry.inverse(m.cuda()), geometry.inverse(m))):
        assert a.is_cuda
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    img = torch.from_numpy(rng.rand(3, 40, 50, 1).astype(np.float32))
    x = torch.from_numpy(rng.rand(3, 999).astype(np.float32) * 60 - 5)
    y = torch.from_numpy(rng.rand(3, 999).astype(np.float32) * 50 - 5)
    np.testing.assert_array_equal(
        bilinear_sample_2d(img.cuda(), x.cuda(), y.cuda(), fused=True)
        .cpu().numpy(), bilinear_sample_2d(img, x, y, fused=True).numpy())
    cells = torch.tensor([float("nan"), float("inf"), -3e9, 2.5, 0.5, -0.5])
    np.testing.assert_array_equal(pcd._cell(cells.cuda()).cpu().numpy(),
                                  pcd._cell(cells).numpy())
