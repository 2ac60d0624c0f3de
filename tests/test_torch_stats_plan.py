"""The stats kernel's plan (K9, ``csrc/rowsweep_stats.cu``) on the CPU.

The kernel has no CPU mode, so this file holds its launch plan
(``aggregate_kernel.stats_plan``) to what the kernel relies on, by the
kernel's own decomposition: block i covers pixel tile i % tiles of item
i / tiles and walks all D planes; lane l of a group of G / 8 lanes keeps
the sums of sources l, l + G / 8, ...; so every (b, d, h, w, source) is
added exactly once. It then emulates the kernel's f64 reduction in torch
(each lane's sum over the planes in order, a fixed shuffle tree a warp, the
block's warps in order, and the final kernel's strided sums and tree over
the blocks' partials) and holds it to the same bits twice and to the
correctly rounded sum. The plain statistics are held to the TPU kernel in
interpret mode by ``test_torch_aggregate_train.py``.
"""
import math

import numpy as np
import pytest
import torch

from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import StatsPlan, stats_plan

BLOCK = 128          # threads a block (csrc/rowsweep_stats.cu kBlock)
WARPS = BLOCK // 32
FINAL = 256          # threads of the final kernel (kFinal)

# (B, D, H, W, G): the three DTU train stages, then extents that the pixel
# tiles do not divide, with D = 1, 3 or 5 and every G
SHAPES = [(4, 48, 64, 80, 32), (4, 24, 128, 160, 16), (4, 8, 256, 320, 8),
          (2, 1, 13, 37, 8), (2, 3, 13, 37, 16), (2, 5, 13, 37, 32),
          (1, 3, 1, 5, 32), (3, 5, 7, 9, 8), (1, 1, 3, 70, 16)]


def _threads(plan: StatsPlan, h, w):
    """Per (block, thread): the item, the pixel (-1 where the thread's
    group holds no pixel of the image) and the lane within the group."""
    hw = h * w
    tiles = -(-hw // plan.pixels)
    blk = np.arange(plan.blocks)[:, None]
    t = np.arange(BLOCK)[None, :]
    pixel = blk % tiles * plan.pixels + t // plan.lanes
    item = np.broadcast_to(blk // tiles, pixel.shape)
    lane = np.broadcast_to(t % plan.lanes, pixel.shape)
    return item, np.where(pixel < hw, pixel, -1), lane


@pytest.mark.parametrize("b,d,h,w,g", SHAPES)
@pytest.mark.parametrize("n_src", [1, 3, 4])
def test_stats_plan_adds_every_voxel_of_every_source_once(b, d, h, w, g,
                                                          n_src):
    """Every (b, d, h, w) of every source is added by exactly one lane:
    the pixel's group in the one block of its tile, on every plane, lane
    s % L for source s."""
    plan = stats_plan(b, d, h, w, g)
    assert plan.lanes * 8 == g and plan.lanes * plan.pixels == BLOCK
    assert plan.planes == d
    assert plan.blocks == b * -(-(h * w) // plan.pixels)
    item, pixel, lane = _threads(plan, h, w)
    counts = np.zeros((n_src, b, d, h * w), np.int64)
    for s in range(n_src):
        mine = (pixel >= 0) & (lane == s % plan.lanes)
        np.add.at(counts[s], (item[mine][:, None], np.arange(d)[None, :],
                              pixel[mine][:, None]), 1)
    assert (counts == 1).all()


def _warp_tree(v: torch.Tensor) -> torch.Tensor:
    """__shfl_down_sync with offsets n/2 .. 1 over the last axis (n lanes
    that share a lane index); returns lane 0's value."""
    n = v.shape[-1]
    v = v.clone()
    off = n // 2
    while off:
        v[..., :off] = v[..., :off] + v[..., off:2 * off]
        off //= 2
    return v[..., 0]


def emulate_stats(field: torch.Tensor, g: int) -> torch.Tensor:
    """The kernel's f64 sums of a (S, B, D, H, W) f32 field, in its order:
    (S, 2) [sum s, sum s^2]."""
    n_src, b, d, h, w = field.shape
    plan = stats_plan(b, d, h, w, g)
    item, pixel, lane = _threads(plan, h, w)
    lanes = plan.lanes
    # the lanes that share lane index l, by warp: (blocks, WARPS, 32 / L)
    sel = (np.arange(WARPS)[:, None] * 32
           + np.arange(0, 32, lanes)[None, :])
    item, pixel = item[:, sel], pixel[:, sel]
    live = torch.from_numpy(pixel >= 0)
    flat = field.reshape(n_src, b, d, h * w)
    out = []
    for s in range(n_src):
        sums = torch.zeros((2,) + pixel.shape, dtype=torch.float64)
        for k in range(d):
            v = flat[s, item, k, np.maximum(pixel, 0)].double()
            v = torch.where(live, v, torch.zeros((), dtype=torch.float64))
            sums = sums + torch.stack([v, v * v])
        warp = _warp_tree(sums)                      # (2, blocks, WARPS)
        part = warp[..., 0]
        for i in range(1, WARPS):
            part = part + warp[..., i]               # (2, blocks)
        # the final kernel: thread t adds partials t, t + 256, ... in
        # order, then a tree over its 256 threads
        acc = torch.zeros((2, FINAL), dtype=torch.float64)
        for i in range(0, plan.blocks, FINAL):
            chunk = part[:, i:i + FINAL]
            acc[:, :chunk.shape[1]] = acc[:, :chunk.shape[1]] + chunk
        out.append(_warp_tree(acc))
    return torch.stack(out)


@pytest.mark.parametrize("b,d,h,w,g", [SHAPES[0], SHAPES[2], SHAPES[4],
                                       SHAPES[7]])
def test_emulated_reduction_is_stable_and_near_the_exact_sum(b, d, h, w, g):
    """The kernel's order over a seeded f32 field with a mean, as the
    pre-BN field has: the same f64 bits twice; within 1e-13 of the
    correctly rounded sum (math.fsum) and of field.double().sum(),
    relative."""
    rng = np.random.RandomState(11)
    n_src = 3
    field = torch.from_numpy(
        (rng.randn(n_src, b, d, h, w) * 0.3 + 0.7).astype(np.float32))
    got = emulate_stats(field, g)
    assert torch.equal(got, emulate_stats(field, g))
    for s in range(n_src):
        x = field[s].double().flatten()
        for j, vals in enumerate((x, x * x)):
            exact = math.fsum(vals.tolist())
            ref = vals.sum().item()
            assert abs(got[s, j].item() - exact) <= 1e-13 * abs(exact)
            assert abs(got[s, j].item() - ref) <= 1e-13 * abs(ref)
