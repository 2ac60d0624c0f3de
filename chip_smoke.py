"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --gate-spread   # the bf16 step gate's readings
    python3 chip_smoke.py --k1-device-ms ROOT   # K1's device time, ROOT's

``--gate-spread`` reads the bf16 step gate's metrics over equally correct
summation orders and over the injected faults (gate_spread), from which
STEP_BOUNDS_BF16 were set, and writes them to build/gate_spread.json.
``--k1-device-ms ROOT`` times K1 at the three DTU eval stages with the
package of the checkout at ROOT (k1_device_ms), to hold two commits'
kernels side by side in one call.

Phases (each prints one line; any failure raises and exits non-zero):
  1. device  — needs CUDA; prints the card's name and power limit;
  2. build   — compiles the hand-written kernels (ops/cuda/csrc) with nvcc;
     the tc kernels', K1's and the co1 kernel's registers (none may spill),
     K1's MUFU instructions in the SASS;
  3. kernels — each kernel vs its plain PyTorch version at the DTU stage
     shapes, bf16 and f32, with times from CUDA events, its bound (the
     least time the card could take for the same work; K1's also on the
     special-function units) and, where one PyTorch call computes the same
     function, that call's time; the bf16 cases of K2-K5 also on the direct
     kernel, which the tensor-core (tc) route must beat by 3x for K2, K3
     and K4 in device time, and the Co = 1 convs (the ProbConvs, refine's
     tail) on the co1 kernel beside the direct kernel, which it must beat
     by 3x at the stage-2 ProbConv; K1's device time at the three stages,
     and K1 on stress cameras at stage 0 (f32); how near the exact (f64)
     sums the tc kernels' f32 sums come beside the direct kernel's (K2, K3,
     K4);
  4. forward — the CoreNet eval forward at 1600x1184, 5 views, B=1, bf16
     convs, seeded random weights with a sharpened posterior: every kernel's
     launch counter must move, the tc, co1 and direct kernels must each
     launch once for each conv and transposed conv that the route rule
     sends to it,
     and the output must agree with the plain f32
     forward on the card: depth (median <= 0.4%, p95 <= 3% of the depth
     range, the bounds of tools/check_fused_oracle.py), confidence, and each
     stage's cost and probability volumes (FORWARD_BOUNDS);
  5. pair    — the conv3d pair kernel (K10, on no model path) on the
     stage-0 U-Net's three stride-1 pairs, fed that forward's own volumes,
     against the two conv3d launches (tc route) each pair replaces;
  6. serve   — ``python -m mdfnet_tpu_torch.cli.eval`` on a synthetic DTU
     eval tree (1600x1200 cropped to 1184, 3 reference views);
  7. train kernels — the training step's kernels at the DTU train shapes
     (640x512, 5 views, batch 4): the sample (K6) and splat (K7) kernels and
     the fused train aggregate's stats kernel and K1 with a per-view affine
     (K9) vs their plain versions at stages 0 and 2, the splat and the stats
     kernel each run twice with bit-identical output, and each
     differentiable conv's (K8) output, input gradient and weight gradient
     vs plain autograd on the plain conv;
  8. train gate — one train step at that configuration on the kernels in
     bf16 against the plain versions in f32 (loss, each stage's cost and
     probability volume, the gradients' cosines: STEP_BOUNDS_BF16), and on
     the kernels in f32 against the plain versions in f32 (loss and every
     parameter's gradient: STEP_BOUNDS_F32); every launch counter of the
     bf16 step must move, the tc kernel's too; the f32 step launches no tc;
     each of five injected faults (FAULTS) must read >= 2x a bf16 bound;
  9. learn   — 20 Adam steps on one batch: finite losses, the last below 0.9
     x the first; ms/step, device time and idle share (torch.profiler),
     peak memory, and one step's time by layer (CUDA events);
  10. train CLI — ``python -m mdfnet_tpu_torch.train --fast`` for one epoch on
     a synthetic DTU train tree; its checkpoint loads strictly into the eval
     model, which then runs;
  11. fused gate — one step of ``ModelConfig(warp_impl="fused")`` (the fused
     train aggregate, K9) under the bf16 and f32 gates above, and the fused
     f32 step against the unfused f32 step on the card (FUSED_BOUNDS), which
     two injected faults (the BN backward without its mean term, K6's 1-px
     shift) must each exceed twice;
     the stats kernel, K1 with the affine, K6 and K7 must all launch;
  12. fused learn — 10 Adam steps of the fused model: finite, falling
     losses; ms/step, peak memory, and the aggregates' forward and backward
     time beside the unfused path's.

The line before the last is one JSON object with every kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# |kernel - plain| / max|plain|: f32 differs by summation order; a bf16
# output may differ by one bf16 rounding step (2^-8 relative) of the value
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MEDIAN_BOUND, P95_BOUND = 0.004, 0.03   # depth error / depth range
# Seeded random weights give a flat posterior (stage-0 peak ~1/48), where
# the regressed depth hardly moves under a wrong kernel. The forward gate
# perturbs every BatchNorm and scales the ProbConv weights by this gain, so
# the posterior has peaks, and bounds more than the depth: each bound is
# ~3x what bf16 rounding alone gives for the same forward at 128x160 on the
# CPU (the plain versions in bf16 vs f32), and below what one zeroed conv3d
# tap, one zeroed trconv3d tap (stages 1-2) or a 1-pixel shift of K1's
# source taps (stage-0 cost) gives there.
PROB_GAIN = 30.0
FORWARD_BOUNDS = {
    "confidence mean |diff|": 1e-2,
    # per stage: mean |diff| / std of the plain f32 volume
    "cost 0": 6e-3, "cost 1": 1.5e-2, "cost 2": 1.5e-2,
    # per stage: mean |diff| of the probability volume
    "prob 0": 2e-4, "prob 1": 6e-4, "prob 2": 2.5e-3,
}
DEPTH_RANGE = (425.0, 935.0)
# the DTU eval configuration: 1600x1200 images cropped to 1184 rows, 5 views
HEIGHT, WIDTH, NVIEWS, SERVE_HEIGHT = 1184, 1600, 5, 1200
NDEPTHS, NGROUPS = (48, 24, 8), (32, 16, 8)
DEV = "cuda"
_SRC = "mdfnet_tpu_torch/ops/cuda/csrc/"
# the least time an H100 SXM could take (its published peak rates): bytes
# over 3.35 TB/s of HBM3, or operations over the peak rate for their type:
# the convolutions' bf16 products (K2-K5, K8, K10) over 989 TFLOP/s, the
# dense bf16 rate of the tensor cores; the f32 elementwise work of K1, K6,
# K7 and K9 over 67 TFLOP/s, the f32 rate of the CUDA cores
PEAK_BYTES_PER_S, PEAK_BF16_TC_PER_S, PEAK_F32_PER_S = 3.35e12, 989e12, 67e12
# K1 also needs the special-function units (MUFU): 16 results per SM and
# clock, 132 SMs at the H100 SXM's 1.98 GHz boost clock
PEAK_MUFU_PER_S = 16 * 132 * 1.98e9
CONV_KERNELS = {"conv3d_bn_act", "trconv3d_bn_act", "conv2d_bn_act",
                "conv2d_chain", "conv3d_pair_bn_act", "conv3d_train",
                "trconv3d_train", "conv2d_train", "conv_co1"}
# K2-K5 (and K8's input gradients) run their bf16 convs with Ci, Co
# multiples of 8 on the tc kernel, the rest on the direct kernel
_TC = dict(source=_SRC + "conv_tc.cu", direct_source=_SRC + "conv_bn_act.cu")
# tc vs direct at K2's, K3's and K4's main-path shapes, at least, in device
# time
TC_SPEEDUP = 3.0
# the Co = 1 kernel vs the direct kernel at the stage-2 ProbConv, at least,
# in device time
CO1_SPEEDUP = 3.0
KERNELS = {   # wrapper name -> its CUDA source and the TPU kernel it replaces
    "rowsweep_aggregate": dict(
        source=_SRC + "rowsweep_aggregate.cu",
        replaces="mdfnet_tpu/ops/pallas/aggregate_kernel.py:427"),
    "conv3d_bn_act": dict(
        **_TC, replaces="mdfnet_tpu/ops/pallas/conv3d_kernel.py:577"),
    "trconv3d_bn_act": dict(
        **_TC, replaces="mdfnet_tpu/ops/pallas/conv3d_kernel.py:741"),
    "conv2d_bn_act": dict(
        **_TC, replaces="mdfnet_tpu/ops/pallas/conv2d_kernel.py:242"),
    "conv2d_chain": dict(
        **_TC, replaces="mdfnet_tpu/ops/pallas/conv2d_kernel.py:654"),
    # K2 (and K4) at Co = 1: the ProbConvs and refine's tail, whichever
    # wrapper launched them (conv_kernel.LAUNCHES["conv_co1"])
    "conv_co1": dict(
        source=_SRC + "conv_co1.cu", direct_source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv3d_kernel.py:577"),
}
# on no model path (as in the JAX package); its launches are the pair phase's
PAIR_KERNEL = {"conv3d_pair_bn_act": dict(
    source=_SRC + "conv3d_pair.cu",
    replaces="mdfnet_tpu/ops/pallas/conv3d_kernel.py:472")}
# the training step's kernels; a K8 entry's launches are its Function's
# input-gradient launches (the conv kernels on mirrored weights)
TRAIN_KERNELS = {
    "sample_2d": dict(
        source=_SRC + "sample_2d.cu",
        replaces="mdfnet_tpu/ops/pallas/warp_kernel.py:143"),
    "splat_2d": dict(
        source=_SRC + "splat_2d.cu",
        replaces="mdfnet_tpu/ops/pallas/splat_kernel.py:129"),
    "conv3d_train": dict(
        **_TC, replaces="mdfnet_tpu/ops/pallas/conv3d_vjp.py:58",
        counter="conv3d_dgrad"),
    "trconv3d_train": dict(
        **_TC, replaces="mdfnet_tpu/ops/pallas/conv3d_vjp.py:112",
        counter="trconv3d_dgrad"),
    "conv2d_train": dict(
        **_TC, replaces="mdfnet_tpu/ops/pallas/conv2d_vjp.py:45",
        counter="conv2d_dgrad"),
}
# the fused train aggregate's kernels (K9); their launches are the fused
# step's (warp_impl="fused")
FUSED_KERNELS = {
    "rowsweep_stats": dict(
        source=_SRC + "rowsweep_stats.cu",
        replaces="mdfnet_tpu/ops/pallas/aggregate_kernel.py:604"),
    "rowsweep_aggregate_with_wsum": dict(
        source=_SRC + "rowsweep_aggregate.cu",
        replaces="mdfnet_tpu/ops/pallas/aggregate_kernel.py:427"),
}
# the reference's training configuration: DTU train 640x512, 5 views, batch 4
TRAIN_HEIGHT, TRAIN_WIDTH, TRAIN_BATCH = 512, 640, 4
# Step gates at this configuration (PERF.md section 2).
# bf16 kernels vs plain f32: bf16 rounding makes single gradients noisy at
# seeded weights (median per-parameter relative error 7e-2 from rounding
# alone; train-mode BN backprop cancels), so the bf16 gate bounds the loss,
# each stage's cost volume (mean |diff| / std) and probability volume
# (mean |diff|), and 1 - the median per-parameter gradient cosine. Each
# bound is at least 2x the worst reading over equally correct summation
# orders, and at most half of what each injected fault (FAULTS) that it is
# there to catch reads (``python3 chip_smoke.py --gate-spread``); every
# fault reads at least 2x one bound (train_gate checks it each run).
STEP_BOUNDS_BF16 = {
    "loss": 5e-4, "cost 0": 0.11, "cost 1": 0.08, "cost 2": 0.057,
    "prob 0": 2e-3, "prob 1": 2.4e-3, "prob 2": 6.3e-3,
    "1 - median cos": 4.4e-3,
}
# f32 kernels vs plain f32 differ by summation order only, which the
# cancelling scalar DepthWeight BatchNorm gradients amplify (4.2e-2 relative
# at most; the median parameter 7e-4): every parameter's gradient is bounded,
# and their median more tightly (the faults give >= 5.6e-2).
STEP_BOUNDS_F32 = {"loss": 1e-5, "grad rel err": 0.12,
                   "median grad rel err": 2e-3}
MIN_COS_F32 = 0.9997
# The fused f32 step (K9) against the unfused f32 step, both on the kernels:
# the same math in another order (f64 statistics, a closed-form backward),
# so f32 noise only. Each bound is ~3x what an H100 gives (PERF.md section
# 2). The worst parameter is a DepthWeight BN bias, whose gradient cancels
# across views (sum_v w_v dL/dw_v = 0 at every voxel): 0.475 relative there,
# against a median of 4.3e-4. The injected fault (the BN backward without
# its mean term) gives 19.5 and a cosine of 0.29.
FUSED_BOUNDS = {"loss": 1e-6, "grad rel err": 1.5,
                "median grad rel err": 1.3e-3}
MIN_COS_FUSED = 0.99985


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(timers: dict, rounds: int = 5) -> dict:
    """The median of ``rounds`` readings of each timer (a function that
    returns milliseconds), read in turn: a call that the host bounds reads
    the host's load, which swings within a run, so the times compared
    share its swings."""
    times = {k: [] for k in timers}
    for _ in range(rounds):
        for k, timer in timers.items():
            times[k].append(timer())
    return {k: statistics.median(v) for k, v in times.items()}


def device_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds of device time per call: ``iters`` calls captured
    in one CUDA graph and replayed, timed by CUDA events, so no host work
    (the wrappers' Python, the launches) stands between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture, as torch
        fn()                           # asks before a capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(name: str, nbytes: float, ops: float, mufu: float = 0.0) -> dict:
    """The least time the card could take for kernel ``name``'s work, which
    moves ``nbytes`` (each input read once, each output written once) and
    does ``ops`` at the peak rate of their type, ``mufu`` of them on the
    special-function units (their time beside the others', where given)."""
    peak = PEAK_BF16_TC_PER_S if name in CONV_KERNELS else PEAK_F32_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops / peak, mufu / PEAK_MUFU_PER_S) * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if mufu:
        out.update(ops_bound_ms=ops / peak * 1e3,
                   mufu_bound_ms=mufu / PEAK_MUFU_PER_S * 1e3)
    return out


def size(*tensors) -> int:
    """Bytes of the tensors."""
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_ops(out_voxels: int, taps: int, ci: int, co: int) -> int:
    """A convolution's multiply-adds as two operations each."""
    return 2 * out_voxels * taps * ci * co


# Operations of the fused aggregate's chain, counting a multiply, an add, a
# compare or an exp as one: per (pixel, plane) q's G sigmoids (3 each); per
# (pixel, plane, source) the projection and taps (30) and per channel the
# bilinear blend (9), p's sigmoid (3), the similarity (5) and k0's dot (2),
# and in K1 also the weight (bn, relu, sigmoid) and the accumulation (2 per
# channel), then G divisions. The stats kernel adds s and s^2 instead.
def aggregate_ops(points: int, n_src: int, g: int, stats: bool) -> int:
    per_source = 32 + 19 * g if stats else 38 + 21 * g
    return points * (3 * g + n_src * per_source + (0 if stats else g))


# K1's special-function operations in their least form: each exact sigmoid
# is an exp and a reciprocal, each division a reciprocal; q's G sigmoids
# once per pixel, per (pixel, plane, source) p's G sigmoids, the weight's
# sigmoid and the projection's two divisions, per voxel one reciprocal of
# the weight sum.
def aggregate_mufu(pixels: int, points: int, n_src: int, g: int) -> int:
    return pixels * 2 * g + points * (n_src * (2 * g + 4) + 1)


def cl(x):
    """Channels-last (NHWC / NDHWC) data as the NCHW / NCDHW view cuDNN takes
    in its channels-last memory format."""
    return x.movedim(-1, 1)


def cl_weight(w):
    return w.contiguous(memory_format=torch.channels_last_3d if w.dim() == 5
                        else torch.channels_last)


def dtu_scene():
    """The synthetic DTU-size scene: a textured tilted plane seen by 5
    cameras at 1600x1184 (DTU-like focal, ~1.8 x width)."""
    from mdfnet_tpu_torch.data import make_plane_scene
    return make_plane_scene(height=HEIGHT, width=WIDTH, nviews=NVIEWS,
                            tilt=0.05, focal=1.8 * WIDTH)


def k1_inputs(gen, scene, dt):
    """K1's arguments at the three DTU eval stages (S = 4 sources; stage 0
    uniform planes, stages 1-2 per-pixel planes), drawn from ``gen``."""
    from mdfnet_tpu_torch import geometry

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(DEV)

    intr = torch.from_numpy(scene.intrinsics)[None].to(DEV)
    extr = torch.from_numpy(scene.extrinsics)[None].to(DEV)
    stages = []
    for stage, (d, g) in enumerate(zip(NDEPTHS, NGROUPS)):
        h, w = HEIGHT >> (3 - stage), WIDTH >> (3 - stage)
        ref_proj, src_projs = geometry.projection_matrices(
            intr, extr, stage, num_stages=4)
        if stage == 0:
            hyp = torch.linspace(*DEPTH_RANGE, d).reshape(1, d, 1, 1)
        else:
            hyp = 560.0 + torch.arange(d).reshape(1, d, 1, 1) * 4.0 \
                + torch.rand(1, 1, h, w, generator=gen) * 40.0
        src = rnd(1, NVIEWS - 1, h, w, g).to(dt)
        ref = rnd(1, h, w, g).to(dt)
        k0 = rnd(g, scale=0.3)
        sc = [torch.tensor(v).to(DEV) for v in (0.9, 0.1, 1.2, -0.2)]
        hyp = hyp.expand(1, d, *hyp.shape[2:]).contiguous().to(DEV)
        stages.append((src, ref, src_projs, ref_proj, hyp, k0, *sc))
    return stages


def k1_stress_inputs(scene):
    """K1's arguments at the DTU stage-0 shape (48 planes, 148x200, G =
    32, f32) on stress cameras: the scene's cameras with source view i
    turned by i x 20 degrees about its y axis, planes from 0.2x the near to
    5x the far depth (their own generator)."""
    from mdfnet_tpu_torch import geometry
    gen = torch.Generator().manual_seed(7)
    d, g, h, w = NDEPTHS[0], NGROUPS[0], HEIGHT >> 3, WIDTH >> 3
    extr = torch.from_numpy(scene.extrinsics).clone()
    for i in range(NVIEWS):
        c, sn = math.cos(math.radians(20.0 * i)), math.sin(math.radians(20.0 * i))
        yaw = torch.tensor([[c, 0, sn, 0], [0, 1, 0, 0], [-sn, 0, c, 0],
                            [0, 0, 0, 1]], dtype=extr.dtype)
        extr[i] = yaw @ extr[i]
    ref_proj, src_projs = geometry.projection_matrices(
        torch.from_numpy(scene.intrinsics)[None].to(DEV), extr[None].to(DEV),
        0, num_stages=4)
    hyp = torch.linspace(0.2 * DEPTH_RANGE[0], 5.0 * DEPTH_RANGE[1], d)
    return (torch.randn(1, NVIEWS - 1, h, w, g, generator=gen).to(DEV),
            torch.randn(1, h, w, g, generator=gen).to(DEV), src_projs,
            ref_proj, hyp.reshape(1, d, 1, 1).to(DEV),
            (torch.randn(g, generator=gen) * 0.3).to(DEV),
            *(torch.tensor(v).to(DEV) for v in (0.9, 0.1, 1.2, -0.2)))


def kernel_cases(gen, scene):
    """(kernel name, dtype, callable(plain) -> tensor, meta) at DTU stage
    shapes; the first case of each kernel is its timed, main-path shape,
    whose meta gives the bytes its inputs hold, its operations and the
    PyTorch call timed beside it (None where there is none)."""
    import torch.nn.functional as F
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel
    from mdfnet_tpu_torch.ops.cuda.conv_kernel import (
        conv2d_bn_act, conv2d_chain, conv3d_bn_act, conv3d_pair_bn_act,
        trconv3d_bn_act)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(DEV)

    # (h, w) at stage s = 0, 1, 2 (1/8, 1/4, 1/2 resolution)
    hw = [(HEIGHT >> (3 - s), WIDTH >> (3 - s)) for s in range(3)]
    (h8, w8), (h4, w4), (h2, w2) = hw
    # the Co = 1 cases beyond those drawn in place (stage-1 and stage-0
    # ProbConvs) take their own generator, which keeps the other cases'
    # inputs as they were
    gen_co1 = torch.Generator().manual_seed(11)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        # K1 — stage 0 (uniform planes), stages 1-2 (per-pixel planes); S=4;
        # device time of K1's kernel alone (kernel_device_ms)
        for a in k1_inputs(gen, scene, dt):
            src, ref, hyp = a[0], a[1], a[4]
            b, d, h, w, g = src.shape[0], hyp.shape[1], *ref.shape[1:]
            meta = dict(in_bytes=size(src, ref, hyp), library=None,
                        ops=aggregate_ops(d * h * w, NVIEWS - 1, g, False),
                        mufu=aggregate_mufu(h * w, d * h * w, NVIEWS - 1, g),
                        kernel="rowsweep_aggregate_kernel")
            cases.append(("rowsweep_aggregate", dt, lambda p, a=a:
                          aggregate_kernel.rowsweep_aggregate(*a, plain=p),
                          meta))

        def epi(co):
            return rnd(co, scale=0.2).abs() + 0.5, rnd(co, scale=0.1)

        def co1_meta(x, wt, e, conv):
            """The Co = 1 kernel's case meta: cuDNN's conv alone as the
            yardstick, the direct kernel beside it."""
            nd = x.dim() - 2
            lib = F.conv3d if nd == 3 else F.conv2d
            return dict(in_bytes=size(x, wt),
                        ops=conv_ops(x.numel() // x.shape[-1], 3 ** nd,
                                     x.shape[-1], 1),
                        library=lambda x=x, wt=cl_weight(wt): lib(
                            cl(x), wt, padding=1),
                        direct=lambda x=x, wt=wt, e=e: conv(
                            x, wt, *e, relu=False, out_dtype=torch.float32,
                            route="direct"))

        def co1_case(x, wt, e, conv):
            return ("conv_co1", dt, lambda p, x=x, wt=wt, e=e: conv(
                x, wt, *e, relu=False, out_dtype=torch.float32, plain=p),
                co1_meta(x, wt, e, conv))

        # K2 — stage-0 U-Net conv01_0 (stride 1) and conv12_0 (stride 2);
        # the yardstick is cuDNN's conv alone. Then the stage-2 ProbConv
        # (Co = 1, f32 out) on the co1 kernel, which must beat the direct
        # kernel by CO1_SPEEDUP in device time
        for shape, co, s in (((1, NDEPTHS[0], h8, w8, NGROUPS[0]), 16, 1),
                             ((1, NDEPTHS[0], h8, w8, 16), 32, 2),
                             ((1, NDEPTHS[2], h2, w2, 8), 1, 1)):
            x = rnd(*shape).to(dt)
            wt = rnd(co, shape[-1], 3, 3, 3, scale=0.1).to(dt)
            out_vox = shape[0] * -(-shape[1] // s) * -(-shape[2] // s) \
                * -(-shape[3] // s)
            e = epi(co)
            if co == 1:
                case = co1_case(x, wt, e, conv3d_bn_act)
                case[3]["speedup"] = CO1_SPEEDUP
                cases.append(case)
                continue
            meta = dict(in_bytes=size(x, wt),
                        ops=conv_ops(out_vox, 27, shape[-1], co),
                        library=lambda x=x, wt=cl_weight(wt), s=s: F.conv3d(
                            cl(x), wt, stride=s, padding=1),
                        direct=lambda x=x, wt=wt, s=s, e=e: conv3d_bn_act(
                            x, wt, *e, stride=s, route="direct"))
            cases.append(("conv3d_bn_act", dt, lambda p, x=x, wt=wt, co=co,
                          s=s, e=e: conv3d_bn_act(
                              x, wt, *e, stride=s, relu=co > 1, plain=p),
                          meta))
        # K3 — stage-0 conv10 with its skip add; stage-1 conv343_2
        for shape, co in (((1, NDEPTHS[0] // 2, h8 // 2, w8 // 2, 32), 16),
                          ((1, NDEPTHS[1] // 8, h4 // 8, w4 // 8, 64), 32)):
            x = rnd(*shape).to(dt)
            wt = rnd(shape[-1], co, 3, 3, 3, scale=0.1).to(dt)
            res = rnd(1, 2 * shape[1], 2 * shape[2], 2 * shape[3], co).to(dt)
            e = epi(co)
            meta = dict(in_bytes=size(x, wt, res),
                        ops=conv_ops(x.numel() // shape[-1], 27, shape[-1],
                                     co),
                        library=lambda x=x, wt=cl_weight(wt):
                        F.conv_transpose3d(cl(x), wt, stride=2, padding=1,
                                           output_padding=1),
                        direct=lambda x=x, wt=wt, r=res, e=e: trconv3d_bn_act(
                            x, wt, *e, residual=r, route="direct"))
            cases.append(("trconv3d_bn_act", dt, lambda p, x=x, wt=wt, r=res,
                          e=e: trconv3d_bn_act(x, wt, *e, residual=r,
                                               plain=p), meta))
        # K4 — backbone conv23_0 (5x5 stride 2), lat2 (1x1 + residual),
        # refine's C->1 tail (f32 out)
        x = rnd(NVIEWS, h2, w2, 16).to(dt)
        w5 = rnd(32, 16, 5, 5, scale=0.05).to(dt)
        e5 = epi(32)
        meta = dict(in_bytes=size(x, w5),
                    ops=conv_ops(NVIEWS * (h2 // 2) * (w2 // 2), 25, 16, 32),
                    library=lambda x=x, wt=cl_weight(w5): F.conv2d(
                        cl(x), wt, stride=2, padding=2),
                    direct=lambda x=x, wt=w5, e=e5: conv2d_bn_act(
                        x, wt, *e, stride=2, route="direct"))
        cases.append(("conv2d_bn_act", dt, lambda p, x=x, wt=w5, e=e5:
                      conv2d_bn_act(x, wt, *e, stride=2, plain=p), meta))
        w1 = rnd(64, 16, 1, 1, scale=0.2).to(dt)
        r1 = rnd(NVIEWS, h2, w2, 64).to(dt)
        cases.append(("conv2d_bn_act", dt, lambda p, x=x, wt=w1, r=r1,
                      e=epi(64): conv2d_bn_act(x, wt, *e, relu=False,
                                               residual=r, plain=p), None))
        # refine's C -> 1 tail on the co1 kernel
        xt = rnd(1, HEIGHT, WIDTH, 8).to(dt)
        wt1 = rnd(1, 8, 3, 3, scale=0.2).to(dt)
        cases.append(co1_case(xt, wt1, epi(1), conv2d_bn_act))
        # K5 — the full-res backbone trunk (3->8, 8->8, 8->16 5x5 stride 2)
        # and refine's half-res stack (Res skips, 0.1 scale); the yardstick
        # is the same three cuDNN convs in a row
        xi = rnd(NVIEWS, HEIGHT, WIDTH, 3).to(dt)
        ws = [rnd(8, 3, 3, 3, scale=0.3).to(dt),
              rnd(8, 8, 3, 3, scale=0.2).to(dt),
              rnd(16, 8, 5, 5, scale=0.1).to(dt)]
        es = [epi(8), epi(8), epi(16)]
        full = NVIEWS * HEIGHT * WIDTH

        def trunk(x=xi, ws=[cl_weight(v) for v in ws]):
            v = F.conv2d(cl(x), ws[0], padding=1)
            v = F.conv2d(v, ws[1], padding=1)
            return F.conv2d(v, ws[2], stride=2, padding=2)
        meta = dict(in_bytes=size(xi, *ws), library=trunk,
                    ops=conv_ops(full, 9, 3, 8) + conv_ops(full, 9, 8, 8)
                    + conv_ops(full // 4, 25, 8, 16),
                    direct=lambda x=xi, ws=ws, es=es: conv2d_chain(
                        x, ws, [e[0] for e in es], [e[1] for e in es],
                        final_stride=2, route="direct"))
        cases.append(("conv2d_chain", dt, lambda p, x=xi, ws=ws, es=es:
                      conv2d_chain(x, ws, [e[0] for e in es],
                                   [e[1] for e in es], final_stride=2,
                                   plain=p), meta))
        xr = rnd(1, h2, w2, 1).to(dt)
        wr = ([rnd(8, 1, 3, 3, scale=0.3)]
              + [rnd(8, 8, 3, 3, scale=0.2) for _ in range(7)]
              + [rnd(32, 8, 3, 3, scale=0.2)])
        ones8 = torch.ones(8, device=DEV)
        scales = ([ones8] + [ones8, ones8 * 0.1] * 3
                  + [ones8, torch.ones(32, device=DEV)])
        cases.append(("conv2d_chain", dt, lambda p, x=xr,
                      ws=[v.to(dt) for v in wr], sc=scales: conv2d_chain(
                          x, ws, sc, [torch.zeros_like(s) for s in sc],
                          relu_flags=(False,) + (True, False) * 3
                          + (False, False),
                          residuals=(None, None, 0, None, 2, None, 4, 0,
                                     None), plain=p), None))
        # the stage-1 and stage-0 ProbConvs on the co1 kernel
        for shape in ((1, NDEPTHS[1], h4, w4, 8),
                      (1, NDEPTHS[0], h8, w8, 16)):
            x = torch.randn(*shape, generator=gen_co1).to(DEV, dt)
            wt = (torch.randn(1, shape[-1], 3, 3, 3, generator=gen_co1)
                  * 0.1).to(DEV, dt)
            e = (torch.rand(1, generator=gen_co1).to(DEV) + 0.5,
                 torch.randn(1, generator=gen_co1).to(DEV) * 0.1)
            cases.append(co1_case(x, wt, e, conv3d_bn_act))
    # K1 on stress cameras at DTU stage 0 (f32, the f32 tolerance)
    cases.append(("rowsweep_aggregate", torch.float32, lambda p, a=(
        k1_stress_inputs(scene)): aggregate_kernel.rowsweep_aggregate(
            *a, plain=p), None))
    # K10 — the stage-0 U-Net's stride-1 pairs at DTU eval: conv01
    # (32->16->16), conv12_1/2 (32->32->32), conv232_1/2 (64->64->64); the
    # yardstick is the same two cuDNN convs in a row. Its own generator
    # keeps the earlier cases' inputs as they were.
    gen10 = torch.Generator().manual_seed(10)

    def rnd10(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen10) * scale).to(DEV)

    def epi10(co):
        return rnd10(co, scale=0.2).abs() + 0.5, rnd10(co, scale=0.1)
    for dt in (torch.bfloat16, torch.float32):
        for shape, ci, cm in (((1, NDEPTHS[0], h8, w8), NGROUPS[0], 16),
                              ((1, NDEPTHS[0] // 2, h8 // 2, w8 // 2), 32, 32),
                              ((1, NDEPTHS[0] // 4, h8 // 4, w8 // 4), 64,
                               64)):
            x = rnd10(*shape, ci, scale=0.5).to(dt)
            wa = rnd10(cm, ci, 3, 3, 3, scale=0.1).to(dt)
            wb = rnd10(cm, cm, 3, 3, 3, scale=0.1).to(dt)
            e1, e2 = epi10(cm), epi10(cm)

            def pair_lib(x=x, wa=cl_weight(wa), wb=cl_weight(wb)):
                return F.conv3d(F.conv3d(cl(x), wa, padding=1), wb,
                                padding=1)

            def beside(x=x, wa=wa, wb=wb, e1=e1, e2=e2):
                return conv3d_bn_act(conv3d_bn_act(x, wa, *e1), wb, *e2)
            vox = x.numel() // ci
            meta = dict(in_bytes=size(x, wa, wb), library=pair_lib,
                        beside=beside,
                        ops=conv_ops(vox, 27, ci, cm) + conv_ops(vox, 27, cm,
                                                                 cm))
            cases.append(("conv3d_pair_bn_act", dt, lambda p, x=x, wa=wa,
                          wb=wb, e1=e1, e2=e2: conv3d_pair_bn_act(
                              x, wa, *e1, wb, *e2, plain=p), meta))
    return cases


def time_case(name, fn, meta, got) -> dict:
    """A timed bf16 case: wall ms per call of back-to-back calls, the plain
    version's, the bound and the library call's; device time where the
    case has a direct route (a CUDA graph's replay, the direct kernel's
    too) or names its kernel (``kernel``: that kernel's own time in a
    profile, kernel_device_ms)."""
    case = {"ms": cuda_ms(lambda: fn(False)),
            "plain_ms": cuda_ms(lambda: fn(True), iters=3),
            **bound(name, meta["in_bytes"] + size(got), meta["ops"],
                    meta.get("mufu", 0)),
            "library_ms": (cuda_ms(meta["library"]) if meta["library"]
                           else None)}
    if "kernel" in meta:
        case["device_ms"] = kernel_device_ms(lambda: fn(False),
                                             meta["kernel"])
    if "direct" in meta:
        case["device_ms"] = device_ms(lambda: fn(False))
        if meta["library"]:
            case["library_device_ms"] = device_ms(meta["library"])
        case["direct_ms"] = cuda_ms(meta["direct"])
        case["direct_device_ms"] = device_ms(meta["direct"])
    return case


def check_kernels(scene):
    """Each kernel vs its plain version; for each timed case (bf16) its
    time, the plain version's, the bound and the library call's. A kernel's
    JSON entry carries its main-path (first) case's numbers, and every
    timed case under "cases"; the tc route must beat the direct kernel by
    TC_SPEEDUP in device time at every timed case of K2, K3 and K4 that
    has both routes, the co1 kernel by CO1_SPEEDUP at the stage-2
    ProbConv."""
    gen = torch.Generator().manual_seed(0)
    report = {}
    for name, dt, fn, meta in kernel_cases(gen, scene):
        got = fn(False)
        ref = fn(True)
        torch.cuda.synchronize()
        require(got.shape == ref.shape and got.dtype == ref.dtype,
                f"{name}: {tuple(got.shape)} {got.dtype} vs plain "
                f"{tuple(ref.shape)} {ref.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-6)
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        line = (f"kernel {name} {str(dt)[6:]} {tuple(got.shape)}: max_abs_err "
                f"{err:.3e} rel {rel:.3e} (tol {REL_TOL[dt]:.0e})")
        case = {}
        if dt == torch.bfloat16 and meta is not None:
            case = time_case(name, fn, meta, got)
            if "ms" not in entry:
                entry.update(case)
            entry.setdefault("cases", []).append(
                {"shape": list(got.shape), **case})
            line += (f"; {case['ms']:.3f} ms vs plain "
                     f"{case['plain_ms']:.3f} ms, bound "
                     f"{case['bound_ms']:.3f} ms ({case['bound_by']}"
                     + (f": operations {case['ops_bound_ms']:.3f}, MUFU "
                        f"{case['mufu_bound_ms']:.3f}" if "mufu_bound_ms"
                        in case else "")
                     + f"), library {case['library_ms']} ms")
            if "direct_ms" in case:
                # both routes, and the library call, by wall time per call
                # (events around back-to-back calls, as "ms") and by device
                # time (a CUDA graph's replay): the wrapper's host work can
                # exceed a short kernel's; the 3x gate is on device time
                route = "co1" if name == "conv_co1" else "tc"
                line += (f"; routes: {route} {case['ms']:.3f} ms, direct "
                         f"{case['direct_ms']:.3f} ms; device time: {route} "
                         f"{case['device_ms']:.3f} ms, direct "
                         f"{case['direct_device_ms']:.3f} ms ("
                         f"{case['direct_device_ms'] / case['device_ms']:.2f}"
                         f"x), library {case['library_device_ms']:.3f} ms")
            elif "device_ms" in case:
                line += f"; device time {case['device_ms']:.3f} ms"
        if dt == torch.bfloat16 and meta and "beside" in meta:
            line += (f"; {cuda_ms(lambda: fn(False)):.3f} ms vs two K2 "
                     f"launches {cuda_ms(meta['beside']):.3f} ms")
        print(line, flush=True)
        require(rel <= REL_TOL[dt] and np.isfinite(err),
                f"{name} disagrees with its plain version")
        require(name not in ("conv3d_bn_act", "trconv3d_bn_act",
                             "conv2d_bn_act")
                or case.get("direct_device_ms", math.inf)
                >= TC_SPEEDUP * case.get("device_ms", 0.0),
                f"{name} {tuple(got.shape)}: the tc kernel is not "
                f"{TC_SPEEDUP}x faster than the direct kernel")
        require(not case or "speedup" not in meta
                or case["direct_device_ms"]
                >= meta["speedup"] * case["device_ms"],
                f"{name} {tuple(got.shape)}: not {meta and meta.get('speedup')}"
                f"x faster than the direct kernel")
    return report


def tc_sums() -> None:
    """How near the exact sums the tc kernel's f32 sums come, against the
    direct kernel's: bf16 inputs at K2's, K3's and K4's main-path shapes,
    f32 output, mean |y - exact| / mean |exact| with the exact conv in f64
    (the tc kernel adds its tensor-core partial sums in f32 every few K
    steps, csrc/conv_tc.cu kFlush)."""
    import torch.nn.functional as F
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    gen = torch.Generator().manual_seed(3)
    h8, w8, h2, w2 = HEIGHT // 8, WIDTH // 8, HEIGHT // 2, WIDTH // 2
    parts = []
    for name, shape, co, k, s in (
            ("K2", (1, NDEPTHS[0], h8, w8, NGROUPS[0]), 16, 3, 1),
            ("K3", (1, NDEPTHS[0] // 2, h8 // 2, w8 // 2, 32), 16, 3, 2),
            ("K4", (NVIEWS, h2, w2, 16), 32, 5, 2)):
        x = torch.randn(*shape, generator=gen).to(DEV, torch.bfloat16)
        wshape = ((shape[-1], co) if name == "K3" else (co, shape[-1]))
        w = (torch.randn(*wshape, *(k,) * (len(shape) - 2),
                         generator=gen) * 0.1).to(DEV, torch.bfloat16)
        one, zero = torch.ones(co, device=DEV), torch.zeros(co, device=DEV)
        if name == "K3":
            exact = F.conv_transpose3d(cl(x).double(), w.double(), stride=2,
                                       padding=1, output_padding=1)
        else:
            exact = (F.conv3d if len(shape) == 5 else F.conv2d)(
                cl(x).double(), w.double(), stride=s, padding=k // 2)
        exact = exact.movedim(1, -1)

        def err(route):
            kw = dict(relu=False, out_dtype=torch.float32, route=route)
            if name == "K3":
                y = conv_kernel.trconv3d_bn_act(x, w, one, zero, **kw)
            elif len(shape) == 5:
                y = conv_kernel.conv3d_bn_act(x, w, one, zero, stride=s, **kw)
            else:
                y = conv_kernel.conv2d_bn_act(x, w, one, zero, stride=s, **kw)
            y = y.double()
            return ((y - exact).abs().mean() / exact.abs().mean()).item()
        tc, direct = err("tc"), err("direct")
        parts.append(f"{name} tc {tc:.2e}, direct {direct:.2e}")
        require(tc <= 1.5 * direct, f"{name}: the tc sums are less exact "
                f"than the direct kernel's ({tc:.2e} vs {direct:.2e})")
        del x, exact
    print("tc sums (mean |f32 - exact| / mean |exact|): " + "; ".join(parts),
          flush=True)


def route_table(traced: list, what: str) -> None:
    """Each distinct conv and transposed conv that a traced run launched
    (conv_kernel.TRACE), at its own shape, timed on each kernel that takes
    it (seeded random bf16 inputs): device time (device_ms, no host between
    launches) and wall time per call of back-to-back calls (cuda_ms,
    interleaved_ms's medians: the wrapper's host work where it exceeds the
    kernel's), and on the tc route the wall time of the weight packing
    alone; the rule's choice beside the other routes, the run's conv time
    summed over its launches on the rule's routes and on the direct
    kernel, and the classes that are slower on the rule's route."""
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    gen = torch.Generator().manual_seed(4)
    counts = {}
    for route, *key in traced:
        counts.setdefault(tuple(key), [route, 0])[1] += 1
    rows, slower = [], []
    total = {(r, t): 0.0 for r in ("rule", "direct") for t in ("dev", "wall")}
    for (kd, k, s, shape, co, tr), (route, n) in counts.items():
        x = torch.randn(*shape, generator=gen).to(DEV, torch.bfloat16)
        wshape = (shape[-1], co) if tr else (co, shape[-1])
        w = (torch.randn(*wshape, *(k,) * (3 if kd == 3 else 2),
                         generator=gen) * 0.1).to(DEV, torch.bfloat16)
        one, zero = torch.ones(co, device=DEV), torch.zeros(co, device=DEV)
        if kd == 1:
            x = x[:, 0]
        if tr:
            conv = (lambda *a, stride, route: conv_kernel.trconv3d_bn_act(
                *a, route=route))
            pack = (lambda w_kio=w.permute(2, 3, 4, 0, 1):
                    conv_kernel.pack_trconv_tc_weight(w_kio))
        else:
            conv = (conv_kernel.conv3d_bn_act if kd == 3
                    else conv_kernel.conv2d_bn_act)
            pack = (lambda w_kio=w.permute(*range(2, w.dim()), 1, 0):
                    conv_kernel.pack_tc_weight(w_kio, kd=kd, k=k, stride=s))
        fns = {r: (lambda r=r: conv(x, w, one, zero, stride=s, route=r))
               for r in ("tc", "co1", "direct") if r in (route, "direct")
               or r == "tc" and conv_kernel.tc_plan(kd, k, s, shape[-1], co,
                                                    tr)}
        ms = {r: {"dev": device_ms(fn, iters=5)} for r, fn in fns.items()}
        walls = interleaved_ms({r: lambda fn=fn: cuda_ms(fn) for r, fn in (
            {**fns, "pack": pack} if "tc" in fns else fns).items()})
        for r, v in ms.items():
            v["wall"] = walls[r]
        if "tc" in ms:
            ms["tc"]["pack"] = walls["pack"]
        for t in ("dev", "wall"):
            total["rule", t] += n * ms[route][t]
            total["direct", t] += n * ms["direct"][t]
        name = (f"{'tr ' if tr else ''}{kd}x{k}x{k}/s{s} {shape[-1]}->{co} "
                f"{tuple(shape[:-1])}")
        slower += [f"{name} by {t}" for other in ms if other != route
                   for t in ("dev", "wall") if ms[route][t] > ms[other][t]]
        rows.append(f"{name} x{n} {route}: " + ", ".join(
            f"{r} {v['dev']:.3f} (wall {v['wall']:.3f}"
            + (f", pack {v['pack']:.3f})" if "pack" in v else ")")
            for r, v in ms.items()))
        del x
    print(f"route table ({what}; conv, input shape, launches per run, the "
          f"rule's route: device ms per launch on each kernel, wall ms per "
          f"call): " + "; ".join(rows) + "; the run's convs on the rule's "
          f"routes ~{total['rule', 'dev']:.2f} ms device, "
          f"~{total['rule', 'wall']:.2f} ms wall; all direct "
          f"~{total['direct', 'dev']:.2f} ms device, "
          f"~{total['direct', 'wall']:.2f} ms wall; slower on the rule's "
          f"route: {slower or 'none'}", flush=True)


def sharpen(model, seed: int = 1) -> None:
    """Perturb every BatchNorm's affine and running statistics (seeded) and
    scale the ProbConv weights by PROB_GAIN, so the posterior is not flat."""
    from mdfnet_tpu_torch.models.layers import BatchNorm
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                for t, v in ((m.weight, 0.8 + 0.4 * torch.rand(n, generator=gen)),
                             (m.bias, 0.1 * torch.randn(n, generator=gen)),
                             (m.running_mean, 0.1 * torch.randn(n, generator=gen)),
                             (m.running_var, 0.5 + torch.rand(n, generator=gen))):
                    t.copy_(v)
        for r in model.Regular:
            r.prob.weight.mul_(PROB_GAIN)


def stage_volumes(model, args, plain):
    """One forward that also returns each stage's cost volume (Homoaggre)
    and probability volume (Regular)."""
    vols, hooks = {}, []
    for kind, mods in (("cost", model.Homoaggre), ("prob", model.Regular)):
        for s, mod in enumerate(mods):
            hooks.append(mod.register_forward_hook(
                lambda _m, _a, o, key=f"{kind} {s}": vols.__setitem__(
                    key, o.float())))
    try:
        out = model(*args, plain=plain)
    finally:
        for h in hooks:
            h.remove()
    return out, vols


def forward_phase(build_s, scene):
    from mdfnet_tpu_torch.data import make_batch
    from mdfnet_tpu_torch.models.conv_routes import eval_conv_routes
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel, conv_kernel

    counters = (aggregate_kernel.LAUNCHES, conv_kernel.LAUNCHES)
    model = build_model(compute_dtype="bfloat16", seed=0, device=DEV)
    sharpen(model)
    plain_model = build_model(seed=0, device=DEV)
    plain_model.load_state_dict(model.state_dict())
    batch = make_batch(scene, batch=1)
    args = [torch.from_numpy(batch[k]).to(DEV)
            for k in ("imgs", "extrinsics", "intrinsics", "depth_range")]

    for c in (*counters, conv_kernel.TC_LAUNCHES):
        for k in c:
            c[k] = 0
    conv_kernel.TRACE = traced = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    conv_kernel.TRACE = None
    # the eval path's kernels (the *_dgrad counters belong to training)
    launches = {k: v for c in counters for k, v in c.items() if k in KERNELS}
    tc = {k: conv_kernel.TC_LAUNCHES[k] for k in launches
          if k in conv_kernel.TC_LAUNCHES}
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    # each kernel once per conv and transposed conv that the rule sends to
    # it, from the model's layers: the tc kernel, the co1 kernel (the
    # ProbConvs, refine's tail) and the direct kernel (the chains' Ci = 3
    # and 1 heads), none of the transposed convs on the direct kernel
    routes = eval_conv_routes(model)
    ran = {"tc": conv_kernel.LAUNCHES["conv_tc"],
           "co1": conv_kernel.LAUNCHES["conv_co1"]}
    ran["direct"] = sum(launches[k] for k in tc) - ran["tc"] - ran["co1"]
    rule = {r: routes.count(r) for r in ran}
    require(ran == rule and min(rule.values()) > 0,
            f"launches by route {ran}, the rule gives {rule}")
    require(launches["trconv3d_bn_act"] == tc["trconv3d_bn_act"],
            f"a transposed conv left the tc kernel: {launches}, tc {tc}")
    print(f"routes: {rule} launches per forward, as the rule gives for the "
          f"model's {len(routes)} convs and transposed convs; tc per wrapper "
          f"{tc}", flush=True)

    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms_map = statistics.median(times[1:])

    out, vols = stage_volumes(model, args, plain=False)
    t0 = time.perf_counter()
    ref, ref_vols = stage_volumes(plain_model, args, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    depth, ref_depth = out["depth"].float(), ref["depth"].float()
    conf = out["confidence"].float()
    require(depth.shape == (1, HEIGHT, WIDTH) and conf.shape == depth.shape,
            f"forward shapes {tuple(depth.shape)} {tuple(conf.shape)}")
    require(bool(torch.isfinite(depth).all() & torch.isfinite(conf).all()),
            "forward produced non-finite values")
    err = ((depth - ref_depth).abs() / (DEPTH_RANGE[1] - DEPTH_RANGE[0])
           ).flatten().cpu().numpy()
    med, p95 = float(np.median(err)), float(np.percentile(err, 95))
    diffs = {"confidence mean |diff|":
             (conf - ref["confidence"].float()).abs().mean().item()}
    for key, r in ref_vols.items():
        d = (vols[key] - r).abs().mean().item()
        diffs[key] = d / r.std().item() if key.startswith("cost") else d
    peaks = [round(ref_vols[f"prob {s}"].amax(1).mean().item(), 4)
             for s in range(len(NDEPTHS))]
    print(f"forward {WIDTH}x{HEIGHT}x{NVIEWS} bf16: {ms_map:.2f} ms/map (median of "
          f"{len(times) - 1}; runs {[round(t, 2) for t in times]}), first map "
          f"{first_s:.2f} s + build {build_s:.1f} s, peak "
          f"{peak_mb:.0f} MiB; vs plain f32 ({plain_s:.2f} s): depth err "
          f"median {med:.2e} p95 {p95:.2e} max {err.max():.2e} of range; "
          + ", ".join(f"{k} {v:.2e} (bound {FORWARD_BOUNDS[k]:.1e})"
                      for k, v in diffs.items())
          + f"; mean peak probability per stage {peaks} (flat: "
          f"{[round(1 / d, 4) for d in NDEPTHS]}); launches {launches}",
          flush=True)
    require(med <= MEDIAN_BOUND and p95 <= P95_BOUND,
            "bf16 kernel forward: depth disagrees with the plain f32 forward")
    for k, v in diffs.items():
        require(v <= FORWARD_BOUNDS[k],
                f"bf16 kernel forward: {k} {v:.2e} > {FORWARD_BOUNDS[k]:.1e}")
    del vols, ref_vols
    profile_phase(model, args, ms_map)
    route_table(traced, "the eval forward")
    return model, args, launches, tc


def pair_phase(model, args) -> int:
    """K10 on the stage-0 U-Net's three stride-1 pairs, fed the eval
    forward's own volumes: each pair against the two conv3d (K2) launches
    that it replaces in that forward, which take the tc route. K10 sums in
    another order and rounds its intermediate as the first launch does, so
    they differ by about one bf16 step (REL_TOL). Returns K10's launches
    here."""
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    reg = model.Regular[0]
    pairs = [(reg.conv01[0], reg.conv01[1]), (reg.conv12[1], reg.conv12[2]),
             (reg.conv232[1], reg.conv232[2])]
    seen, hooks = {}, []
    for i, (first, second) in enumerate(pairs):
        hooks += [first.register_forward_pre_hook(
                      lambda _m, a, i=i: seen.__setitem__(("in", i), a[0])),
                  second.register_forward_hook(
                      lambda _m, _a, o, i=i: seen.__setitem__(("out", i), o))]
    try:
        model(*args)
    finally:
        for h in hooks:
            h.remove()
    conv_kernel.LAUNCHES["conv3d_pair_bn_act"] = 0
    outs = []
    for i, (first, second) in enumerate(pairs):
        x = seen["in", i]
        outs.append(conv_kernel.conv3d_pair_bn_act(
            x, *first.folded(x.dtype), *second.folded(x.dtype)))
    torch.cuda.synchronize()
    launches = conv_kernel.LAUNCHES["conv3d_pair_bn_act"]
    errs = []
    for i, got in enumerate(outs):
        ref = seen["out", i].float()
        errs.append((got.float() - ref).abs().max().item()
                    / max(ref.abs().max().item(), 1e-6))
    print(f"pair: the stage-0 U-Net's stride-1 pairs "
          f"{[tuple(seen['in', i].shape) for i in range(3)]} on K10 vs two "
          f"K2 launches (tc) each: rel err {[f'{e:.2e}' for e in errs]} (tol "
          f"{REL_TOL[torch.bfloat16]:.0e}); launches {launches}", flush=True)
    require(launches == 3 and all(e <= REL_TOL[torch.bfloat16] for e in errs),
            "pair phase: K10 disagrees with the two K2 launches")
    return launches


def _layer_names(model) -> list[str]:
    """The names of the model's top-level layers."""
    stages = range(len(model.Regular))
    return (["Backbone"] + [f"Homoaggre.{s}" for s in stages]
            + [f"Regular.{s}" for s in stages] + ["Refine"])


def device_profile(fn, ntop: int) -> tuple[float, float, str]:
    """One profiled call of ``fn`` (torch.profiler, CUPTI): (device busy
    us, wall us, the ``ntop`` kernels with the most device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the kernels (and copies) themselves
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])

    def short(key):
        key = key.replace("void ", "").replace("(anonymous namespace)::", "")
        return key.replace("__nv_bfloat16", "bf16")[:64]
    top = ", ".join(f"{short(k)} {t / 1e3:.2f}ms" for k, t in rows[:ntop])
    return sum(t for _, t in rows), wall_us, top


def profile_phase(model, args, ms_map):
    """Where one forward's time goes: device time by kernel (torch.profiler,
    CUPTI) and by layer (CUDA events around the top-level modules).

    The idle share is measured within the profiled forward, whose host time
    the profiler inflates; the share of an unprofiled forward is estimated
    from this forward's device time and ``ms_map``, the median host time of
    the unprofiled forwards of the same run."""
    busy, wall_us, top = device_profile(lambda: model(*args), 12)
    print(f"profile: device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"wall of the profiled forward (idle {1 - busy / wall_us:.1%}); "
          f"estimated idle of an unprofiled forward (vs its median "
          f"{ms_map:.2f} ms) {1 - busy / 1e3 / ms_map:.1%}; top: {top}",
          flush=True)

    events, hooks = {}, []
    for name in _layer_names(model):
        mod = model.get_submodule(name)
        def pre(_m, _a, name=name):
            events[name] = [torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)]
            events[name][0].record()

        def post(_m, _a, _o, name=name):
            events[name][1].record()
        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    model(*args)
    end.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    total = start.elapsed_time(end)
    layers = {k: a.elapsed_time(b) for k, (a, b) in events.items()}
    rest = total - sum(layers.values())
    print("layers (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      layers.items())
          + f", other {rest:.2f}, total {total:.2f}", flush=True)


def serve_phase(model):
    from mdfnet_tpu_torch.data import (read_pair_file, read_pfm,
                                       write_dtu_eval_tree, write_pair_file)
    from mdfnet_tpu_torch.utils.weights import save_checkpoint

    work = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        tree = os.path.join(work, "dtu1600x1200")
        write_dtu_eval_tree(tree, scans=(9,), nviews=NVIEWS,
                            height=SERVE_HEIGHT, width=WIDTH)
        _, pairs = read_pair_file(os.path.join(tree, "pair.txt"))
        write_pair_file(os.path.join(tree, "pair.txt"), pairs[:3])
        ckpt = os.path.join(work, "seed0.pth")
        save_checkpoint(model, ckpt)
        outdir = os.path.join(work, "outputs")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mdfnet_tpu_torch.cli.eval", "-p", ckpt,
             "--root", work, "-o", outdir, "--scans", "9"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        log = (proc.stdout + proc.stderr).strip().splitlines()
        require(proc.returncode == 0,
                "eval CLI failed:\n" + "\n".join(log[-30:]))
        for ref, _ in pairs[:3]:
            for sub, ext in (("depth_est", ".pfm"), ("depth_est", ".png"),
                             ("confidence", ".pfm")):
                path = os.path.join(outdir, "scan9", sub, f"{ref:08d}{ext}")
                require(os.path.exists(path), f"eval CLI did not write {path}")
            depth, _ = read_pfm(os.path.join(outdir, "scan9", "depth_est",
                                             f"{ref:08d}.pfm"))
            require(depth.shape == (HEIGHT, WIDTH) and np.isfinite(depth).all(),
                    f"view {ref}: depth {depth.shape} not finite/full-size")
        print(f"serve: eval CLI wrote 3 views in {cli_s:.1f} s; "
              f"{log[-1].split(': ', 1)[-1]}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------------ training


def train_batch():
    """The DTU train configuration's batch on the card: a synthetic tilted
    plane seen by 5 cameras at 640x512, 4 items."""
    from mdfnet_tpu_torch.data import make_batch, make_plane_scene
    from mdfnet_tpu_torch.train_lib import batch_to_device
    scene = make_plane_scene(height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
                             nviews=NVIEWS, tilt=0.05, focal=1.8 * TRAIN_WIDTH)
    return batch_to_device(make_batch(scene, batch=TRAIN_BATCH), DEV)


def _rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that / max |ref|) over a tensor or a tuple."""
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    err = rel = 0.0
    for g, r in zip(got, ref):
        require(g.shape == r.shape, f"shapes {tuple(g.shape)} vs {tuple(r.shape)}")
        e = (g.float() - r.float()).abs().max().item()
        err, rel = max(err, e), max(rel, e / max(r.float().abs().max().item(),
                                                 1e-12))
    return err, rel


def train_kernel_cases(gen, batch):
    """(name, dtype, run(plain) -> result, time(plain) -> ms, meta) at the
    DTU train shapes; the first case of each name is its timed, main-path
    shape (bf16), whose meta gives the bytes its timed work moves, its
    operations and the PyTorch call timed beside it (None where there is
    none). K8 results are (output, d_input, d_weight): the kernel Function
    against plain autograd on the plain conv; its time, bound and yardstick
    are the input gradient's."""
    import torch.nn.functional as F
    from mdfnet_tpu_torch import geometry
    from mdfnet_tpu_torch.ops.cuda import exact_cuda_math
    from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import (
        rowsweep_aggregate_with_wsum, rowsweep_stats)
    from mdfnet_tpu_torch.ops.cuda.conv_vjp import (conv2d_train,
                                                    conv3d_train,
                                                    trconv3d_train)
    from mdfnet_tpu_torch.ops.cuda.splat_kernel import splat_2d
    from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d
    from mdfnet_tpu_torch.ops.warp import sweep_sample_coords

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(DEV)

    b, s = TRAIN_BATCH, NVIEWS - 1
    cases, geo = [], {}
    # K6 / K7 — stage 0 (48 uniform planes, 1/8 res, G = 32) and stage 2
    # (8 per-pixel planes, 1/2 res, G = 8), all 4 sources of 4 items
    for stage, d, g in ((0, NDEPTHS[0], NGROUPS[0]), (2, NDEPTHS[2], NGROUPS[2])):
        h, w = TRAIN_HEIGHT >> (3 - stage), TRAIN_WIDTH >> (3 - stage)
        ref_proj, src_projs = geometry.projection_matrices(
            batch["intrinsics"].float(), batch["extrinsics"].float(), stage,
            num_stages=4)
        if stage == 0:
            hyp = torch.linspace(*DEPTH_RANGE, d).reshape(1, d, 1, 1) \
                .expand(b, d, 1, 1)
        else:
            hyp = 560.0 + torch.arange(d).reshape(1, d, 1, 1) * 4.0 \
                + torch.rand(b, 1, h, w, generator=gen) * 40.0
        x, y = sweep_sample_coords(src_projs, ref_proj, hyp.to(DEV), h, w)
        geo[stage] = (src_projs, ref_proj, hyp.to(DEV), d, h, w, g)
        # grid_sample's normalised grid for the same samples (align_corners
        # False): x_pixel = ((gx + 1) W - 1) / 2
        grid = torch.stack([(2.0 * x + 1.0) / w - 1.0,
                            (2.0 * y + 1.0) / h - 1.0], -1)
        grid = grid.reshape(b * s, d, h * w, 2)
        for dt in (torch.bfloat16, torch.float32):
            img = rnd(b * s, h, w, g).to(dt)
            gr = rnd(b * s, d, h, w, g).to(dt)
            sample = (lambda p, img=img, x=x, y=y: sample_2d(img, x, y, plain=p))
            splat = (lambda p, gr=gr, x=x, y=y, h=h, w=w:
                     splat_2d(gr, x, y, h, w, plain=p))
            n_samples = x.numel()
            gd = grid.to(dt)
            img_nchw = cl(img)
            g_nchw = gr.reshape(b * s, d, h * w, g).permute(0, 3, 1, 2)
            sample_meta = dict(
                nbytes=size(img, x, y, gr), ops=n_samples * (10 + 9 * g),
                library=lambda img=img_nchw, gd=gd: F.grid_sample(
                    img, gd, mode="bilinear", padding_mode="zeros",
                    align_corners=False))
            splat_meta = dict(
                nbytes=size(gr, x, y) + b * s * h * w * g * 4,
                ops=n_samples * (10 + 8 * g),
                library=lambda gn=g_nchw, img=img_nchw, gd=gd:
                torch.ops.aten.grid_sampler_2d_backward(
                    gn, img, gd, 0, 0, False, [True, False]))
            cases += [("sample_2d", dt, sample,
                       lambda p, f=sample: cuda_ms(lambda: f(p)), sample_meta),
                      ("splat_2d", dt, splat,
                       lambda p, f=splat: cuda_ms(lambda: f(p)), splat_meta)]

    def plain_conv(kind, stride):
        def run(x, w):
            exact_cuda_math()
            xf, wf = x.float().movedim(-1, 1), w.float()
            if kind == "trconv3d_train":
                y = F.conv_transpose3d(xf, wf, stride=2, padding=1,
                                       output_padding=1)
            else:
                conv = F.conv3d if x.dim() == 5 else F.conv2d
                y = conv(xf, wf, stride=stride, padding=wf.shape[-1] // 2)
            return y.movedim(1, -1)
        return run

    kernel_conv = {
        "conv3d_train": lambda st: lambda x, w: conv3d_train(x, w, st),
        "trconv3d_train": lambda st: trconv3d_train,
        "conv2d_train": lambda st: lambda x, w: conv2d_train(x, w, st)}
    h8, w8 = TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8
    n = b * NVIEWS
    timed = set()
    # K8 — stage-0 U-Net conv01_0 (s1), conv12_0 (s2), conv232_3 (the
    # transposed conv), ProbConv (Co = 1); full-res backbone conv01_1 (3x3
    # s1) and conv12_0 (5x5 s2: its input gradient is a library call); lat2.
    # The yardstick is cuDNN's input gradient of the same convolution.
    for kind, xshape, wshape, stride in (
            ("conv3d_train", (b, NDEPTHS[0], h8, w8, 32), (16, 32, 3, 3, 3), 1),
            ("conv3d_train", (b, NDEPTHS[0], h8, w8, 16), (32, 16, 3, 3, 3), 2),
            ("conv3d_train", (b, NDEPTHS[0], h8, w8, 16), (1, 16, 3, 3, 3), 1),
            ("trconv3d_train", (b, NDEPTHS[0] // 4, h8 // 4, w8 // 4, 64),
             (64, 32, 3, 3, 3), 2),
            ("conv2d_train", (n, TRAIN_HEIGHT, TRAIN_WIDTH, 8), (8, 8, 3, 3), 1),
            ("conv2d_train", (n, TRAIN_HEIGHT, TRAIN_WIDTH, 8), (16, 8, 5, 5), 2),
            ("conv2d_train", (n, TRAIN_HEIGHT // 2, TRAIN_WIDTH // 2, 16),
             (64, 16, 1, 1), 1)):
        for dt in (torch.bfloat16, torch.float32):
            x = rnd(*xshape).to(dt)
            wt = rnd(*wshape, scale=0.1).to(dt)
            fns = {False: kernel_conv[kind](stride),
                   True: plain_conv(kind, stride)}
            out = fns[False](x, wt)
            gout = rnd(*out.shape)
            del out

            def grads(p, x=x, wt=wt, gout=gout, fns=fns):
                xg, wg = x.detach().requires_grad_(True), \
                    wt.detach().requires_grad_(True)
                y = fns[p](xg, wg)
                # the same (dtype-rounded) cotangent for both
                dx, dw = torch.autograd.grad(y, (xg, wg),
                                             gout.to(x.dtype).to(y.dtype))
                return y.detach(), dx, dw

            def backward_ms(p, x=x, wt=wt, gout=gout, fns=fns):
                """The input gradient alone, from a recorded forward."""
                xg = x.detach().requires_grad_(True)
                y = fns[p](xg, wt)
                g = gout.to(y.dtype)
                return cuda_ms(lambda: torch.autograd.grad(
                    y, xg, g, retain_graph=True), iters=20)
            meta = None
            if dt == torch.bfloat16 and kind not in timed:
                timed.add(kind)
                nd = len(wshape) - 2
                tr = kind == "trconv3d_train"
                taps, ci = math.prod(wshape[2:]), xshape[-1]
                co = wshape[1] if tr else wshape[0]
                vox = (x.numel() // ci if tr
                       else gout.numel() // co)
                pad = wshape[-1] // 2
                meta = dict(
                    nbytes=size(x, wt) + gout.numel() * x.element_size(),
                    ops=conv_ops(vox, taps, ci, co),
                    library=lambda x=x, wt=cl_weight(wt), go=gout.to(dt),
                    st=stride, nd=nd, pad=pad, tr=tr:
                    torch.ops.aten.convolution_backward(
                        cl(go), cl(x), wt, None, [st] * nd, [pad] * nd,
                        [1] * nd, tr, [1 if tr else 0] * nd, 1,
                        [True, False, False]))
            cases.append((kind, dt, grads, backward_ms, meta))

    # K9 — the fused train aggregate's stats kernel and K1 with a per-view
    # BN affine, at stages 0 and 2 (its own generator keeps the earlier
    # cases' inputs as they were)
    gen9 = torch.Generator().manual_seed(9)
    for stage in (0, 2):
        src_projs, ref_proj, hyp, d, h, w, g = geo[stage]
        hyp = hyp.expand(b, d, *hyp.shape[2:]).contiguous()
        for dt in (torch.bfloat16, torch.float32):
            src = torch.randn(b, s, h, w, g, generator=gen9).to(DEV, dt)
            ref = torch.randn(b, h, w, g, generator=gen9).to(DEV, dt)
            k0 = (torch.randn(g, generator=gen9) * 0.3).to(DEV)
            bn = ((torch.rand(s, generator=gen9) + 0.5).to(DEV),
                  (torch.randn(s, generator=gen9) * 0.2).to(DEV),
                  torch.tensor(1.2, device=DEV), torch.tensor(-0.2, device=DEV))
            args = (src, ref, src_projs, ref_proj, hyp, k0)
            points = b * d * h * w
            stats = (lambda p, a=args: rowsweep_stats(*a, plain=p))
            wsum = (lambda p, a=args, bn=bn:
                    rowsweep_aggregate_with_wsum(*a, *bn, plain=p))
            first = dt == torch.bfloat16 and stage == 0
            cases += [
                ("rowsweep_stats", dt, stats,
                 lambda p, f=stats: cuda_ms(lambda: f(p)),
                 dict(nbytes=size(src, ref, hyp, k0), library=None,
                      ops=aggregate_ops(points, s, g, True)) if first
                 else None),
                ("rowsweep_aggregate_with_wsum", dt, wsum,
                 lambda p, f=wsum: cuda_ms(lambda: f(p)),
                 dict(nbytes=size(src, ref, hyp, k0) + points * (g + 1) * 4,
                      library=None, ops=aggregate_ops(points, s, g, False),
                      mufu=aggregate_mufu(b * h * w, points, s, g))
                 if first else None)]
    return cases


def check_train_kernels(batch):
    from mdfnet_tpu_torch.ops.cuda.splat_kernel import splat_2d
    gen = torch.Generator().manual_seed(1)
    report = {}
    for name, dt, run, timer, meta in train_kernel_cases(gen, batch):
        got, ref = run(False), run(True)
        torch.cuda.synchronize()
        err, rel = _rel_err(got, ref)
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        shape = tuple((got[0] if isinstance(got, tuple) else got).shape)
        line = (f"train kernel {name} {str(dt)[6:]} {shape}: max_abs_err "
                f"{err:.3e} rel {rel:.3e} (tol {REL_TOL[dt]:.0e})")
        if name in ("splat_2d", "rowsweep_stats"):
            again = run(False)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"{name}: two launches on the same inputs differ")
            line += "; two launches bit-identical"
        if meta is not None and "ms" not in entry:
            # wall per call of back-to-back calls, mostly the host's time
            entry.update(interleaved_ms({"ms": lambda: timer(False),
                                         "plain_ms": lambda: timer(True)}))
            entry.update(bound(name, meta["nbytes"], meta["ops"],
                               meta.get("mufu", 0)))
            entry["library_ms"] = (cuda_ms(meta["library"])
                                   if meta["library"] else None)
            line += (f"; {entry['ms']:.3f} ms vs plain "
                     f"{entry['plain_ms']:.3f} ms, bound "
                     f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}), "
                     f"library {entry['library_ms']} ms")
            if name.endswith("_train"):
                line += " (input gradient)"
        print(line, flush=True)
        require(rel <= REL_TOL[dt] and np.isfinite(err),
                f"{name} disagrees with its plain version")
        del got, ref
    return report


def _step(dtype: str, plain: bool, batch, *, launches=None,
          warp_impl: str = "dense"):
    """One train step's loss, gradients and per-stage volumes from the
    seed-0 weights, convs in ``dtype`` ("bfloat16" or "float32").
    ``launches``: the counters to zero before the step and read after it
    (the main path's run); ``warp_impl="fused"``: the fused train
    aggregate."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.train_lib import loss_and_grads
    model = build_model(ModelConfig(warp_impl=warp_impl), compute_dtype=dtype,
                        seed=0, device=DEV).requires_grad_(True)
    vols, hooks = {}, []
    for kind, mods in (("cost", model.Homoaggre), ("prob", model.Regular)):
        for s, mod in enumerate(mods):
            hooks.append(mod.register_forward_hook(
                lambda _m, _a, o, key=f"{kind} {s}": vols.__setitem__(
                    key, o.detach().float())))
    if launches is not None:
        for c in launches:
            for k in c:
                c[k] = 0
    torch.cuda.synchronize()
    loss = loss_and_grads(model, batch, plain=plain)
    torch.cuda.synchronize()
    counts = ({k: v for c in launches for k, v in c.items()}
              if launches is not None else None)
    for h in hooks:
        h.remove()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    return float(loss), grads, vols, counts


def _grad_stats(grads, ref):
    errs, coss = {}, {}
    for n, r in ref.items():
        g = grads[n].flatten().double()
        r = r.flatten().double()
        errs[n] = ((g - r).norm() / r.norm()).item()
        coss[n] = (g @ r / (g.norm() * r.norm())).item()
    return errs, coss


def bf16_gate_metrics(step, ref) -> dict:
    """The bf16 step gate's metrics of a step's (loss, gradients, volumes)
    against the plain f32 step's ``ref``: the loss's relative error, each
    stage's cost volume mean |diff| / std and probability volume mean
    |diff|, and 1 - the median per-parameter gradient cosine."""
    (loss_b, grads_b, vols_b), (loss_p, grads_p, vols_p) = step, ref
    metrics = {"loss": abs(loss_b - loss_p) / abs(loss_p)}
    for key, r in vols_p.items():
        d = (vols_b[key] - r).abs().mean().item()
        metrics[key] = d / r.std().item() if key.startswith("cost") else d
    _, coss = _grad_stats(grads_b, grads_p)
    metrics["1 - median cos"] = 1.0 - float(np.median(list(coss.values())))
    return metrics


def _zeroed_corner_tap(hit):
    """A conv kernel fault: every launch that ``hit(kd, k, Co, transposed)``
    selects runs with its weights' corner tap (0, 0, 0) zeroed, its input
    gradients' launches included (the kernels' plain versions stay
    exact)."""
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    launch = conv_kernel._launch

    def faulty(counter, x5, w_kio, *args, kd, k, transposed=False, **kw):
        if hit(kd, k, w_kio.shape[-1], transposed):
            w_kio = w_kio.clone()
            w_kio[(0,) * (w_kio.dim() - 2)] = 0.0
        return launch(counter, x5, w_kio, *args, kd=kd, k=k,
                      transposed=transposed, **kw)
    return [(conv_kernel, "_launch", faulty)]


def _shifted_sample_taps():
    """A K6 fault: its launches sample one pixel to the right."""
    from mdfnet_tpu_torch.ops import aggregate_train, warp
    from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d

    def faulty(image, x, y, *, plain=False):
        return sample_2d(image, x if plain else x + 1.0, y, plain=plain)
    return [(warp, "sample_2d", faulty), (aggregate_train, "sample_2d", faulty)]


# The step gates' injected faults: name -> the patches that inject it. The
# fused step runs K6 only in its backward, where the bf16 gate's metrics
# read its fault as they read a correct order (PERF.md section 2), so the
# fused f32 gate (fused_gate) holds that fault instead.
K6_FAULT = "K6 1-px shift"
FAULTS = {
    "conv3d tap": lambda: _zeroed_corner_tap(
        lambda kd, k, co, tr: kd == 3 and not tr and co > 1),
    "trconv3d tap": lambda: _zeroed_corner_tap(lambda kd, k, co, tr: tr),
    "conv2d 3x3 tap": lambda: _zeroed_corner_tap(
        lambda kd, k, co, tr: kd == 1 and k == 3),
    "ProbConv tap": lambda: _zeroed_corner_tap(
        lambda kd, k, co, tr: kd == 3 and not tr and co == 1),
    K6_FAULT: _shifted_sample_taps,
}


@contextlib.contextmanager
def patched(patches):
    """Set each (module, name, value) of ``patches``; restore on exit."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, v in patches:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _show(metrics: dict) -> str:
    return ", ".join(f"{k} {v:.2e}" for k, v in metrics.items())


def train_gate(batch, warp_impl: str = "dense"):
    """The bf16 and f32 step gates; returns the bf16 step's launches, its
    tc-route launches per conv counter, and the f32 kernel step's (loss,
    gradients). The f32 step must take the direct kernels only. Each of
    FAULTS (in the fused step all but K6_FAULT), injected into the bf16
    step, must read at least twice its bound on one of the bf16 gate's
    metrics."""
    from mdfnet_tpu_torch.ops.cuda import (aggregate_kernel, conv_kernel,
                                           splat_kernel, warp_kernel)
    counters = (warp_kernel.LAUNCHES, splat_kernel.LAUNCHES,
                conv_kernel.LAUNCHES, aggregate_kernel.LAUNCHES)
    conv_kernel.TRACE = traced = []
    loss_b, grads_b, vols_b, launches = _step(
        "bfloat16", False, batch, launches=counters + (
            conv_kernel.TC_LAUNCHES,), warp_impl=warp_impl)
    conv_kernel.TRACE = None
    tc = dict(conv_kernel.TC_LAUNCHES)
    launches = {k: v for c in counters for k, v in c.items()}
    if warp_impl == "dense":
        route_table(traced, "the bf16 train step, forward and input "
                    "gradients")
    # the chain and the eval aggregate run in eval only, and no model path
    # runs the pair; the fused aggregate's kernels run with warp_impl="fused"
    step_ids = [k for k in launches if k not in (
        "conv2d_chain", "conv3d_pair_bn_act", "rowsweep_aggregate")
        and (warp_impl == "fused" or k not in FUSED_KERNELS)]
    require(all(launches[k] > 0 for k in step_ids),
            f"a kernel of the train step never launched: {launches}")
    loss_p, grads_p, vols_p, _ = _step("float32", True, batch,
                                       warp_impl=warp_impl)
    ref = (loss_p, grads_p, vols_p)
    # bf16 kernels vs plain f32
    diffs = bf16_gate_metrics((loss_b, grads_b, vols_b), ref)
    errs, coss = _grad_stats(grads_b, grads_p)
    print(f"{warp_impl} train gate bf16 kernels vs plain f32 ("
          f"{TRAIN_WIDTH}x{TRAIN_HEIGHT}"
          f"x{NVIEWS}, batch {TRAIN_BATCH}): loss {loss_b:.4f} vs "
          f"{loss_p:.4f}; " + ", ".join(
              f"{k} {v:.2e}" + (f" (bound {STEP_BOUNDS_BF16[k]:.1e})"
                                if k in STEP_BOUNDS_BF16 else " (no bound)")
              for k, v in diffs.items())
          + f"; gradients over {len(errs)} parameters: rel err median "
          f"{np.median(list(errs.values())):.2e} max {max(errs.values()):.2e}"
          f" ({max(errs, key=errs.get)}), cosine min "
          f"{min(coss.values()):.4f}; launches {launches}", flush=True)
    for k, b in STEP_BOUNDS_BF16.items():
        require(diffs[k] <= b, f"train gate bf16: {k} {diffs[k]:.2e} > {b:.1e}")
    del grads_b, vols_b
    caught = []
    for name, patches in FAULTS.items():
        with patched(patches()):
            loss_x, grads_x, vols_x, _ = _step("bfloat16", False, batch,
                                               warp_impl=warp_impl)
        m = bf16_gate_metrics((loss_x, grads_x, vols_x), ref)
        del grads_x, vols_x
        over = {k: m[k] / b for k, b in STEP_BOUNDS_BF16.items()}
        worst = max(over, key=over.get)
        caught.append(f"{name}: {worst} {over[worst]:.1f}x")
        require(over[worst] >= 2.0 or (warp_impl, name) == ("fused", K6_FAULT),
                f"train gate bf16: the injected fault '{name}' reads within "
                f"2x of every bound ({_show(m)})")
    print(f"{warp_impl} train gate bf16, injected faults (the metric most "
          f"over its bound): " + "; ".join(caught), flush=True)
    # f32 kernels vs plain f32: every parameter
    loss_k, grads_k, _, f32_launches = _step("float32", False, batch,
                                             launches=counters,
                                             warp_impl=warp_impl)
    require(f32_launches["conv_tc"] == 0 and f32_launches["conv3d_bn_act"] > 0,
            f"the f32 step left the direct conv kernel: {f32_launches}")
    errs, coss = _grad_stats(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(errs, key=errs.get)
    med_err = float(np.median(list(errs.values())))
    print(f"{warp_impl} train gate f32 kernels vs plain f32: loss rel "
          f"{loss_rel:.2e} "
          f"(bound {STEP_BOUNDS_F32['loss']:.0e}); gradients of all "
          f"{len(errs)} parameters: rel err max {errs[worst]:.2e} ({worst}; "
          f"bound {STEP_BOUNDS_F32['grad rel err']:.2e}) median "
          f"{med_err:.2e} (bound "
          f"{STEP_BOUNDS_F32['median grad rel err']:.0e}), cosine min "
          f"{min(coss.values()):.6f} (bound {MIN_COS_F32})", flush=True)
    require(loss_rel <= STEP_BOUNDS_F32["loss"], "train gate f32: loss")
    require(med_err <= STEP_BOUNDS_F32["median grad rel err"],
            f"train gate f32: median gradient error {med_err:.2e}")
    bad = [n for n in errs if errs[n] > STEP_BOUNDS_F32["grad rel err"]
           or coss[n] < MIN_COS_F32]
    require(not bad, f"train gate f32: gradients out of bounds: {bad[:5]}")
    return launches, tc, (loss_k, grads_k)


# ------------------------------------------------- the bf16 gate's spread

# Equally correct summation orders of the bf16 step, read in this tree:
# name -> the conv route rule it runs under, made from the tree's own rule
ORDERS = {
    "tree": lambda rule: rule,
    "tree again": lambda rule: rule,
    "K3 direct": lambda rule: lambda dt, kd, k, s, ci, co, tr=False: (
        "direct" if tr else rule(dt, kd, k, s, ci, co)),
    "all direct": lambda rule: lambda *a: "direct",
}
# ... and in copies of this tree, outside it, whose tc kernel flushes its
# tensor-core sums every N K steps (csrc/conv_tc.cu kFlush; unflushed: one
# run per GEMM or weight stage)
FLUSHES = {"kFlush 3": 3, "kFlush 27": 27, "unflushed": 1 << 20}


def gate_readings(names) -> dict:
    """The bf16 gate's metrics (bf16_gate_metrics) of the dense and the
    fused step under each of ``names`` (ORDERS or FAULTS), each against the
    plain f32 step of its path."""
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    rule = conv_kernel.conv_route
    batch = train_batch()
    out = {}
    for impl in ("dense", "fused"):
        loss_p, grads_p, vols_p, _ = _step("float32", True, batch,
                                           warp_impl=impl)
        for name in names:
            patches = (FAULTS[name]() if name in FAULTS else
                       [(conv_kernel, "conv_route", ORDERS[name](rule))])
            with patched(patches):
                loss, grads, vols, _ = _step("bfloat16", False, batch,
                                             warp_impl=impl)
            out.setdefault(name, {})[impl] = bf16_gate_metrics(
                (loss, grads, vols), (loss_p, grads_p, vols_p))
            del grads, vols
        del grads_p, vols_p
    return out


def _readings(root: str, names) -> dict:
    """gate_readings(names) in a process of its own, run from ``root``."""
    proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"),
                           "--gate-readings", *names], cwd=root,
                          capture_output=True, text=True, timeout=900)
    lines = [v for v in proc.stdout.splitlines()
             if v.startswith("GATE_READINGS ")]
    require(proc.returncode == 0 and lines, f"gate readings {names} failed:\n"
            + "\n".join((proc.stdout + proc.stderr).splitlines()[-30:]))
    return json.loads(lines[-1][len("GATE_READINGS "):])


def gate_spread() -> None:
    """The bf16 step gate's metrics over equally correct summation orders
    (ORDERS in this tree; FLUSHES in copies of it under a temporary
    directory, each built on the card) and over the injected FAULTS; prints
    both tables, with 2x the worst correct reading of each metric, and
    writes them to build/gate_spread.json."""
    readings = _readings(ROOT, [*ORDERS, *FAULTS])
    with tempfile.TemporaryDirectory() as tmp:
        for name, every in FLUSHES.items():
            copy = os.path.join(tmp, name.replace(" ", "_"))
            shutil.copytree(os.path.join(ROOT, "mdfnet_tpu_torch"),
                            os.path.join(copy, "mdfnet_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
            src = os.path.join(copy, _SRC, "conv_tc.cu")
            with open(src) as f:
                text = f.read()
            require("constexpr int kFlush = 9;" in text, "kFlush not found")
            with open(src, "w") as f:
                f.write(text.replace("constexpr int kFlush = 9;",
                                     f"constexpr int kFlush = {every};"))
            readings[name] = _readings(copy, ["tree"])["tree"]
    orders = [n for n in readings if n not in FAULTS]
    metrics = list(readings["tree"]["dense"])
    worst = {m: max(readings[o][i][m] for o in orders
                    for i in ("dense", "fused")) for m in metrics}
    for title, names in (("orders", orders), ("faults", list(FAULTS))):
        print(f"gate spread, {title} (dense / fused): " + "; ".join(
            f"{n}: " + ", ".join(
                f"{m} {readings[n]['dense'][m]:.2e} / "
                f"{readings[n]['fused'][m]:.2e}" for m in metrics)
            for n in names), flush=True)
    print("gate spread: 2x the worst correct reading: "
          + _show({m: 2 * v for m, v in worst.items()}), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "gate_spread.json"), "w") as f:
        json.dump({"readings": readings, "orders": orders,
                   "faults": list(FAULTS)}, f, indent=1)


def _versus(loss, grads, loss_ref, grads_ref) -> dict:
    """Loss, worst and median gradient error, worst cosine against a
    reference step."""
    errs, coss = _grad_stats(grads, grads_ref)
    worst = max(errs, key=errs.get)
    return {"loss": abs(loss - loss_ref) / abs(loss_ref),
            "grad rel err": errs[worst], "worst": worst,
            "median grad rel err": float(np.median(list(errs.values()))),
            "cosine min": min(coss.values())}


def fused_gate(batch, unfused_f32):
    """The fused train aggregate's step (warp_impl="fused") under the bf16
    and f32 gates, then the fused f32 step against the unfused f32 step on
    the kernels (FUSED_BOUNDS), and the same with each of two faults
    injected into the fused backward (the BN backward without its mean
    term; K6_FAULT, which only this gate sees there), each of which must
    read at least twice a bound. Returns the fused bf16 step's launches."""
    from mdfnet_tpu_torch.ops import aggregate_train
    launches, _, (loss_f, grads_f) = train_gate(batch, warp_impl="fused")
    require(all(launches[k] > 0 for k in (*FUSED_KERNELS, "sample_2d",
                                           "splat_2d")),
            f"a kernel of the fused step never launched: {launches}")
    clean = _versus(loss_f, grads_f, *unfused_f32)
    del grads_f

    def without_mean(d_shat, s_hat, r):
        m2 = (d_shat * s_hat).sum(dtype=torch.float64) / d_shat.numel()
        return r * (d_shat - s_hat * m2.float())
    faults = {"the BN backward without its mean term":
              [(aggregate_train, "bn_backward", without_mean)],
              K6_FAULT: FAULTS[K6_FAULT]()}
    read = {}
    for name, patches in faults.items():
        with patched(patches):
            loss_x, grads_x, _, _ = _step("float32", False, batch,
                                          warp_impl="fused")
        read[name] = _versus(loss_x, grads_x, *unfused_f32)
        del grads_x

    def show(v):
        return (f"loss rel {v['loss']:.2e}, grad rel err max "
                f"{v['grad rel err']:.2e} ({v['worst']}) median "
                f"{v['median grad rel err']:.2e}, cosine min "
                f"{v['cosine min']:.6f}")

    def over(v):
        """Each bound the reading exceeds at least twice."""
        return ([k for k, b in FUSED_BOUNDS.items() if v[k] >= 2 * b]
                + (["cosine min"] if 1 - v["cosine min"]
                   >= 2 * (1 - MIN_COS_FUSED) else []))
    print(f"fused vs unfused f32 step on the kernels: {show(clean)} (bounds "
          f"{FUSED_BOUNDS}, cosine >= {MIN_COS_FUSED}); injected faults: "
          + "; ".join(f"{n}: {show(v)}, >= 2x {over(v)}"
                      for n, v in read.items())
          + f"; launches {launches}", flush=True)
    for k, b in FUSED_BOUNDS.items():
        require(clean[k] <= b, f"fused vs unfused: {k} {clean[k]:.2e} > {b}")
    require(clean["cosine min"] >= MIN_COS_FUSED,
            f"fused vs unfused: cosine {clean['cosine min']:.6f}")
    for name, v in read.items():
        require(over(v), f"the injected fault '{name}' in the fused "
                         "backward stays within 2x of the fused-vs-unfused "
                         "bounds")
    return launches


def learn_phase(batch, smi, warp_impl: str = "dense", steps: int = 20,
                profile: bool = True):
    """Adam steps on one batch (bf16 kernels): the loss falls; ms/step
    (median after 2 warm-up steps), peak memory, profiled device time and
    idle share, and one step's time by layer, which it returns."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.train_lib import make_optimizer, poly_lr, train_step
    model = build_model(ModelConfig(warp_impl=warp_impl),
                        compute_dtype="bfloat16", seed=0,
                        device=DEV).requires_grad_(True)
    opt = make_optimizer(model, poly_lr(1, 1e-3, 30, 0.9))
    losses, times = [], []
    for i in range(steps):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(model, opt, batch)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms_step = statistics.median(times[2:])
    print(f"{warp_impl} learn: losses {[round(v, 2) for v in losses]}",
          flush=True)
    line = (f"{warp_impl} train step {TRAIN_WIDTH}x{TRAIN_HEIGHT}x{NVIEWS} "
            f"batch {TRAIN_BATCH} bf16 on {smi}: {ms_step:.2f} ms/step "
            f"(median of {len(times) - 2}; runs "
            f"{[round(t, 1) for t in times]}), peak {peak_mb:.0f} MiB")
    if profile:
        busy, wall_us, top = device_profile(
            lambda: train_step(model, opt, batch), 14)
        line += (f"; profiled step: device busy {busy / 1e3:.2f} ms of "
                 f"{wall_us / 1e3:.2f} ms wall (idle {1 - busy / wall_us:.1%})"
                 f"; estimated idle of an unprofiled step (vs its median) "
                 f"{1 - busy / 1e3 / ms_step:.1%}; top: {top}")
    print(line, flush=True)
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < 0.9 * losses[0], f"no learning: {losses}")
    return train_layers(model, opt, batch)


def train_layers(model, opt, batch):
    """One train step's time by layer, from CUDA events: around each
    top-level module's forward, at the start of each one's backward (its
    backward pre-hook) and around the loss and Adam. Autograd runs the
    modules' backwards in reverse forward order, so each module's backward
    runs from its own mark to the next one; Refine's includes the
    regression's, Backbone's ends with the backward."""
    from mdfnet_tpu_torch.models.loss import multi_scale_depth_loss

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    fwd, bwd, hooks = {}, [], []
    for name in _layer_names(model):
        mod = model.get_submodule(name)
        hooks += [
            mod.register_forward_pre_hook(
                lambda _m, _a, name=name: fwd.__setitem__(name, [mark()])),
            mod.register_forward_hook(
                lambda _m, _a, _o, name=name: fwd[name].append(mark())),
            mod.register_full_backward_pre_hook(
                lambda _m, _g, name=name: bwd.append((name, mark())))]
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    start = mark()
    out = model(*(batch[k] for k in ("imgs", "extrinsics", "intrinsics",
                                     "depth_range")), train=True)
    loss = multi_scale_depth_loss(out["depth"], batch["ref_depths"],
                                  batch["depth_range"])
    fwd_end = mark()
    with warnings.catch_warnings():
        # the backbone's input (the images) needs no gradient: its hook
        # fires on the output gradients, which is what the mark wants
        warnings.filterwarnings("ignore", "Full backward hook", UserWarning)
        loss.backward()
    bwd_end = mark()
    opt.step()
    end = mark()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    require([n for n, _ in bwd] == ["Refine"] + [
        f"{k}.{s}" for s in reversed(range(len(model.Regular)))
        for k in ("Regular", "Homoaggre")] + ["Backbone"],
        f"backward order {[n for n, _ in bwd]}")
    forward = {k: a.elapsed_time(b) for k, (a, b) in fwd.items()}
    backward = {n: e.elapsed_time(nxt) for (n, e), nxt in
                zip(bwd, [e for _, e in bwd[1:]] + [bwd_end])}
    total = start.elapsed_time(end)
    print("train layers (ms, one step): forward " + ", ".join(
        f"{k} {v:.2f}" for k, v in forward.items())
        + f", other + loss {start.elapsed_time(fwd_end) - sum(forward.values()):.2f}"
        + f"; loss backward {fwd_end.elapsed_time(bwd[0][1]):.2f}; backward "
        + ", ".join(f"{k} {v:.2f}" for k, v in backward.items())
        + f"; Adam {bwd_end.elapsed_time(end):.2f}; total {total:.2f}",
        flush=True)
    return forward, backward


def fused_learn_phase(batch, smi, unfused_layers):
    """10 Adam steps of the fused model (warp_impl="fused"); its aggregates'
    forward and backward times beside the unfused path's."""
    forward, backward = learn_phase(batch, smi, warp_impl="fused", steps=10,
                                    profile=False)
    names = [f"Homoaggre.{s}" for s in range(len(NDEPTHS))]
    print("aggregates (ms, one step, fused vs unfused): " + ", ".join(
        f"{n} forward {forward[n]:.2f} vs {unfused_layers[0][n]:.2f}, "
        f"backward {backward[n]:.2f} vs {unfused_layers[1][n]:.2f}"
        for n in names), flush=True)


def train_cli_phase():
    from mdfnet_tpu_torch.data import make_batch, make_plane_scene
    from mdfnet_tpu_torch.data import write_dtu_train_tree
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.utils.weights import load_checkpoint

    work = os.path.join(ROOT, "build", "smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    try:
        # 7 views: robust sampling draws 4 sources from len(srcs) - 1
        write_dtu_train_tree(os.path.join(work, "dtu640x512"), scans=(1,),
                             nviews=7, lightings=1, height=TRAIN_HEIGHT,
                             width=TRAIN_WIDTH)
        out = os.path.join(work, "ckpt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mdfnet_tpu_torch.train", "-d", "dtu",
             "--root", work, "--scans", "1", "--lightings", "1", "--epochs",
             "1", "--batch-size", str(TRAIN_BATCH), "--fast", "--ckpt-dir",
             out], cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        log = (proc.stdout + proc.stderr).strip().splitlines()
        require(proc.returncode == 0,
                "train CLI failed:\n" + "\n".join(log[-30:]))
        with open(os.path.join(out, "epoch_loss.txt")) as f:
            losses = [float(v) for v in f.read().split()]
        require(len(losses) == 1 and np.isfinite(losses[0]),
                f"epoch_loss.txt: {losses}")
        model = build_model(compute_dtype="bfloat16", device=DEV, seed=5)
        epoch = load_checkpoint(model, os.path.join(out, "dtu_1.pth"))
        scene = make_plane_scene(height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
                                 nviews=NVIEWS, tilt=0.05,
                                 focal=1.8 * TRAIN_WIDTH)
        b = make_batch(scene, batch=1)
        depth = model(*(torch.from_numpy(b[k]).to(DEV) for k in (
            "imgs", "extrinsics", "intrinsics", "depth_range")))["depth"]
        require(depth.shape == (1, TRAIN_HEIGHT, TRAIN_WIDTH)
                and bool(torch.isfinite(depth).all()),
                "the trained checkpoint's eval forward is not finite")
        print(f"train CLI: 1 epoch in {cli_s:.1f} s, epoch loss "
              f"{losses[0]:.4f}; dtu_1.pth (epoch {epoch}) loads strict=True "
              f"into the eval model, whose forward is finite", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled ``*_kernel`` symbol: the name is
    the identifier that its length prefix (the tail of a digit run) fits."""
    for m in re.finditer(r"_kernel(?:I(\w+?)EE)?", mangled):
        end = m.start() + len("_kernel")
        for i in range(end - len("_kernel"), 0, -1):
            digits = re.search(r"(\d+)$", mangled[:i])
            if digits and digits[1].endswith(str(end - i)):
                return mangled[i:end] + (f"<{m[1]}>" if m[1] else "")
    return mangled


def kernel_device_ms(fn, kernel: str, iters: int = 10) -> float:
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``kernel`` (torch.profiler, CUPTI), over ``iters`` calls after one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    require(us > 0, f"no {kernel} kernel in the trace")
    return us / iters / 1e3


def k1_device_ms(root: str) -> None:
    """K1's own device time at the three DTU eval stages (bf16, the kernel
    phase's inputs), by kernel_device_ms, and a digest of each stage's
    output bytes, for the package of the checkout at ``root`` (say a parent
    commit's ``git archive``, whose kernels build under its own build/):
    one line ``K1_DEVICE_MS {...}``. Run it for two checkouts in one call
    to compare them on one card; equal digests mean equal bits."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel
    require(aggregate_kernel.__file__.startswith(root + os.sep),
            f"{aggregate_kernel.__file__} is not under {root}")
    gen = torch.Generator().manual_seed(0)
    ms, digests = [], []
    for a in k1_inputs(gen, dtu_scene(), torch.bfloat16):
        ms.append(kernel_device_ms(
            lambda a=a: aggregate_kernel.rowsweep_aggregate(*a),
            "rowsweep_aggregate_kernel"))
        out = aggregate_kernel.rowsweep_aggregate(*a).cpu().numpy()
        digests.append(hashlib.sha256(out.tobytes()).hexdigest()[:16])
    print("K1_DEVICE_MS " + json.dumps({"root": root, "stages_ms": ms,
                                        "digests": digests}), flush=True)


def sass_mufu(lib_path) -> dict:
    """K1's special-function instructions in the library's SASS (cuobjdump
    -sass), per instantiation: (MUFU.EX2, MUFU.RCP) in the code, each
    counted once wherever it sits (the per-plane loop or not)."""
    from mdfnet_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = _kernel_name(block.split("\n", 1)[0].strip())
        if name.startswith("rowsweep_aggregate_kernel"):
            out[name] = (block.count("MUFU.EX2"), block.count("MUFU.RCP"))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:2] == ["--gate-readings"]:
        print("GATE_READINGS " + json.dumps(gate_readings(sys.argv[2:])))
        return
    if sys.argv[1:] == ["--gate-spread"]:
        gate_spread()
        return
    if sys.argv[1:2] == ["--k1-device-ms"] and len(sys.argv) == 3:
        k1_device_ms(sys.argv[2])
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from mdfnet_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    build_s = time.perf_counter() - t0
    # ptxas -v, per entry function: registers and spill stores
    kern = {}
    for block in lib_path.with_suffix(".log").read_text().split(
            "Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        kern[_kernel_name(block.split("'")[0])] = (
            int(regs[1]) if regs else 0, int(spill[1]) if spill else 0)
    most = max(kern, key=lambda k: kern[k][0], default="")
    spills = [f"{k} {v[1]} B" for k, v in kern.items() if v[1]]
    tc = {k: v for k, v in kern.items() if k.startswith("conv_tc_kernel")}
    tr = {k: v for k, v in kern.items() if k.startswith("trconv_tc_kernel")}
    print(f"build: {build_s:.1f} s -> {os.path.relpath(lib_path, ROOT)}; "
          f"{len(kern)} kernels, most registers {kern.get(most, (0,))[0]} "
          f"({most}); spill stores: {', '.join(spills) or 'none'}; the tc "
          f"kernels (registers, spill store bytes): "
          + ", ".join(f"{k} {v}" for k, v in {**tc, **tr}.items()),
          flush=True)
    require(len(tc) == 8 and len(tr) == 6
            and not any(v[1] for v in (*tc.values(), *tr.values())),
            f"the tc kernels' instantiations spill or are missing: {tc} {tr}")
    # K1 (3 G x 2 dtypes x eval/train) and the co1 kernel (3 dtype pairs x
    # KD 1, 3 x 8 or 16 channels a stage): registers, spills; K1's MUFU
    # instructions in the SASS
    k1 = {k: v for k, v in kern.items()
          if k.startswith("rowsweep_aggregate_kernel")}
    co1 = {k: v for k, v in kern.items() if k.startswith("conv_co1_kernel")}
    print("build: K1 and the co1 kernel (registers, spill store bytes): "
          + ", ".join(f"{k} {v}" for k, v in {**k1, **co1}.items())
          + "; K1's MUFU instructions (static, EX2 + RCP): "
          + ", ".join(f"{k} {v}" for k, v in sass_mufu(lib_path).items()),
          flush=True)
    require(len(k1) == 12 and len(co1) == 12
            and not any(v[1] for v in (*k1.values(), *co1.values())),
            f"K1's or the co1 kernel's instantiations spill or are missing: "
            f"{k1} {co1}")

    def entry(name, info, report, launches, tc_launches=None):
        info = dict(info)
        info.pop("counter", None)
        extra = {} if tc_launches is None else {"tc_launches": tc_launches}
        return dict(name=name, route="cuda", **info, **report[name],
                    launches=launches, **extra)

    scene = dtu_scene()
    report = check_kernels(scene)
    tc_sums()
    model, args, launches, tc = forward_phase(build_s, scene)
    kernels = [entry(n, info, report, launches[n], tc.get(n))
               for n, info in KERNELS.items()]
    pair_launches = pair_phase(model, args)
    kernels += [entry(n, info, report, pair_launches)
                for n, info in PAIR_KERNEL.items()]
    serve_phase(model)
    del model, args

    batch = train_batch()
    report = check_train_kernels(batch)
    launches, tc, unfused_f32 = train_gate(batch)
    kernels += [entry(n, info, report, launches[info.get("counter", n)],
                      tc.get(info.get("counter", n)))
                for n, info in TRAIN_KERNELS.items()]
    unfused_layers = learn_phase(batch, smi)
    train_cli_phase()
    launches = fused_gate(batch, unfused_f32)
    kernels += [entry(n, info, report, launches[n])
                for n, info in FUSED_KERNELS.items()]
    fused_learn_phase(batch, smi, unfused_layers)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
