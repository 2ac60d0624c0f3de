"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --gate-spread   # the bf16 step gate's readings
    python3 chip_smoke.py --device-ms ROOT   # K1, K7, K9 device time, ROOT's
    python3 chip_smoke.py --chain-tiles [ROOT]   # the chain kernel at each tile
    python3 chip_smoke.py --eval-profile ROOT   # the eval forward, ROOT's
    python3 chip_smoke.py --spatial   # the spatial phase alone

``--gate-spread`` reads the bf16 and f32 step gates' metrics over equally
correct summation orders and over the injected faults (gate_spread), from
which STEP_BOUNDS_BF16, STEP_BOUNDS_F32 and F32_LAYER_SHARE were set, and
writes them to build/gate_spread.json. ``--chain-tiles`` times each chain
call of the eval forward on the chain kernel at each final tile that fits,
beside the per-layer route (chain_tiles): conv_kernel's CHAIN_FUSED rule
and its tiles, and CHAIN_CASE_TILES, come from it; with ROOT, the package
of the checkout at ROOT runs them (a parent's ``git archive``, to hold two
commits' chain kernels side by side in one call).
``--device-ms ROOT`` times K1 at the three DTU eval stages and K7 and K9
(the stats kernel and K1's train launch) at the three DTU train stages with
the package of the checkout at ROOT (device_ms_mode), with digests of their
outputs, to hold two commits' kernels side by side in one call.
``--eval-profile ROOT`` runs the bf16 eval forward at DTU and Tanks
2048x1056 with the package of the checkout at ROOT (eval_profile_mode):
ms/map, peak memory, device ms, ATen's elementwise and ``cat`` device ms,
time by layer.

Phases (each prints one line; any failure raises and exits non-zero):
  1. device  — needs CUDA; prints the card's name and power limit;
  2. build   — compiles the hand-written kernels (ops/cuda/csrc) with nvcc;
     the tc kernels', K1's, the co1 kernel's and the stats kernel's
     registers (none may spill), K1's and the stats kernel's MUFU
     instructions in the SASS, and the instructions of the stats kernel's
     loops;
  3. kernels — each kernel vs its plain PyTorch version at the DTU stage
     shapes, bf16 and f32, with times from CUDA events, its bound (the
     least time the card could take for the same work; K1's also on the
     special-function units) and, where one PyTorch call computes the same
     function, that call's time; the bf16 cases of K2-K4 also on the direct
     kernel, which the tensor-core (tc) route must beat by 3x for K2, K3
     and K4 in device time, and the Co = 1 convs (the ProbConvs, refine's
     tail) on the co1 kernel beside the direct kernel, which it must beat
     by 3x at the stage-2 ProbConv; each chain call of the forward (K5:
     the trunk, the 16-, 32- and 64-channel pairs, refine's stack) on the
     chain kernel beside its per-layer route, read in turn CHAIN_ROUNDS
     times, the rule's route the faster by the median of the rounds'
     ratios; K1's device time at the three stages,
     and K1 on stress cameras at stage 0 (f32); K6 at the variance
     aggregate's eval shapes (k6_eval_cases: one source, DTU stages 0 and
     2), grid_sample beside it; how near the exact (f64)
     sums the tc kernels' f32 sums come beside the direct kernel's (K2, K3,
     K4, the chain kernel's Ci = 3 and 1 heads);
  4. forward — the CoreNet eval forward at 1600x1184, 5 views, B=1, bf16
     convs, seeded random weights with a sharpened posterior: every kernel's
     launch counter must move, the chain kernel must launch once for each
     chain that chain_route fuses and the tc, co1 and direct kernels once
     for each conv and transposed conv that the route rule sends to them
     (the backbone's top-down path: three composed 1x1 convs on tc),
     and the output must agree with the plain f32
     forward on the card: depth (median <= 0.4%, p95 <= 3% of the depth
     range, the bounds of tools/check_fused_oracle.py), confidence, and each
     stage's cost and probability volumes (FORWARD_BOUNDS);
  5. pair    — the conv3d pair kernel (K10, on no model path) on the
     stage-0 U-Net's three stride-1 pairs, fed that forward's own volumes,
     against the two conv3d launches (tc route) each pair replaces;
  6. serve   — ``python -m mdfnet_tpu_torch.cli.eval`` on a synthetic DTU
     eval tree (1600x1200 cropped to 1184, 3 reference views);
  6'. alternatives — each alternative unit (ALT_CONFIGS: the variance
     aggregate, ATV hypotheses, RefineNet v1, gauss0 curves, all four, and
     the vector aggregate at C/G = 4, ngroups=(16, 8, 4), on K6) at
     the DTU eval shape: the f32 kernel forward vs the plain f32 forward
     (EXACT_BOUNDS), its launches by route as the rule gives and K6's (or
     K1's); the bf16 forward's ms/map and peak memory, its output against
     the plain f32 forward (the forward gate, FORWARD_BOUNDS), and each of
     its conv launches (the tc kernel at Ci = C under the variance
     aggregate, RefineNet v1's convs) against its plain version on the
     same inputs (REL_TOL, uncounted launches); one train step of
     all four and one of C/G = 4 (ALT_TRAIN) at DTU train, f32 kernels vs
     plain f32 (STEP_BOUNDS_F32), with K6, K7 and K8 launched;
  6a. tanks  — the eval forward at the Tanks & Temples shapes (11 views,
     1920x1056 and 2048x1056): K1 against its plain version at the three
     stages with S = 10 sources (bf16 and f32), every kernel of the path
     launched, ms per map, device busy time, peak memory and the forward
     gate above; then ``cli.eval -d tanks`` on a synthetic Tanks tree (two
     scenes, one of each width, two reference views each) and ``cli.eval
     -d tanks --exact`` (the kernels in f32) on one view against the plain
     f32 forward (EXACT_BOUNDS);
  6b. fusion — ``python -m mdfnet_tpu_torch.cli.fuse -m filter|vote|pcd`` on
     the card over an 11-view synthetic DTU scan at 1600x1184 with GT depth:
     each cloud holds FUSION_MIN_SHARE of the pixels and lies on the plane
     (FUSION_SURFACE); seconds per view, pcd's split (the native election's
     share); one reference view's per-view functions on the card (TF32
     allowed) against the CPU under the tie rule (tests/_fusion_scenes.py);
  6c. metric — ``cli.dtu_eval`` on a cloud fused (vote, on the card) from a
     400x296 11-view scan: Acc, Comp and Overall (METRIC_BOUND);
  7. train kernels — the training step's kernels at the DTU train shapes
     (640x512, 5 views, batch 4): the sample kernel (K6) vs its plain
     version at stages 0 and 2 (and at C/G = 4: one source's 64 or 16
     channels, with K7); the splat kernel (K7) and the fused train
     aggregate's kernels (K9: the stats kernel, on K1's lane groups with
     all planes a block, and K1 with a per-view affine) at stages 0, 1 and
     2 and on stress cameras at stage 0, each stage timed in bf16 and f32,
     split by kernel, and summed over a step's 3 launches; the
     splat and the stats kernel each run twice with bit-identical output,
     and each differentiable conv's (K8) output, input gradient and weight
     gradient vs plain autograd on the plain conv; each timed by wall and by device
     time (every kernel of one call in a profile);
  8. train gate — one train step at that configuration on the kernels in
     bf16 against the plain versions in f32 (loss, each stage's cost and
     probability volume, the gradients' cosines: STEP_BOUNDS_BF16), and on
     the kernels in f32 against the plain versions in f32 (loss and every
     parameter's gradient, its error over a floor of its layer's gradient:
     STEP_BOUNDS_F32); every launch counter of the bf16 step must move, the
     tc kernel's too; the f32 step launches no tc; each of six injected
     faults (FAULTS) must read >= 2x an f32 bound and, but the faults of
     the backward alone (BF16_BLIND: K7's 1-px shift), >= 2x a bf16 bound;
  9. learn   — 20 Adam steps on one batch: finite losses, the last below 0.9
     x the first; ms/step, device time and idle share (torch.profiler),
     peak memory, and one step's time by layer (CUDA events);
  10. train CLI — ``python -m mdfnet_tpu_torch.train --fast`` for one epoch on
     a synthetic DTU train tree; its checkpoint loads strictly into the eval
     model, which then runs;
  11. fused gate — one step of ``ModelConfig(warp_impl="fused")`` (the fused
     train aggregate, K9) under the bf16 and f32 gates above, and the fused
     f32 step against the unfused f32 step on the card (FUSED_BOUNDS), which
     three injected faults (the BN backward without its mean term, K6's and
     K7's 1-px shifts) must each exceed twice;
     the stats kernel, K1 with the affine, K6 and K7 must all launch;
  12. fused learn — 10 Adam steps of the fused model: finite, falling
     losses; ms/step, peak memory, and the aggregates' forward and backward
     time beside the unfused path's;
  13. data parallel — DP_WORLD spawned ranks split the DTU train batch
     (parallel/mesh.py; a card a rank over NCCL, else both on one card
     over gloo, a check of correctness, not scaling): rank 0's reduced
     gradients and averaged running statistics after one f32 step against
     the one-process emulation (train_lib.data_parallel_reference) under
     STEP_BOUNDS_F32 and DP_STATS_BOUND; rank 0 skipping the gradient
     reduction must read >= 2x a bound; equal digests of every parameter,
     buffer and Adam moment after DP_BF16_STEPS bf16 steps; ms/step and
     peak a rank; then the train CLI with --world-size 2 (one checkpoint,
     strict load); every rank joined within DP_TIMEOUT;
  14. remat — ModelConfig(remat=True): one f32 step against the plain one
     (STEP_BOUNDS_F32, running statistics bit-equal), and the bf16 step's
     peak memory and ms with and without remat at REMAT_SHAPES;
  15. spatial — the eval forward at DTU full width, 1600x1152 x 5 views
     (the 1184 crop aligned to 32 x 4 rows), with H sharded over 2 and 4
     spawned ranks (parallel/spatial.py): sharing the card over gloo on a
     one-card machine (a check of correctness and memory, not a scaling
     number), a card a rank over NCCL where there are enough: the f32
     kernels sharded vs unsharded (SPATIAL_BOUNDS), the bf16 sharded
     forward vs the plain f32 unsharded one under the forward gate's
     depth and confidence bounds and its share of pixels whose bits
     differ from the bf16 unsharded forward, a zeroed halo (>= 2x a
     bound), every kernel of the path launched on every rank, peak memory,
     ms/map and all-reduces per rank beside the unsharded; at n = 2 the
     ngroups=(16, 8, 4) config on K6; K1's band launch at stage 0 (Hs !=
     H) vs its plain version and the full launch; ``cli.eval --spatial 2``
     in a session of its own.

The profile lines (DTU, both Tanks widths) give device busy time, ATen's
elementwise and ``cat`` device time and the time by layer. After the
phases, ``total:`` gives the script's seconds. The line before the last
is one JSON object with every kernel's launches, error and times; the last
line is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import signal
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
# Tanks & Temples eval: 1080-high images cropped to 1056 rows, 11 views (10
# sources), at the two widths its scenes come in; the synthetic scenes' focal
# (x width) and camera spacing keep view 10 over most of the reference
TANKS_WIDTHS, TANKS_SCENES = (1920, 2048), ("Family", "Horse")
TANKS_HEIGHT, TANKS_IMAGE_HEIGHT, TANKS_NVIEWS = 1056, 1080, 11
TANKS_FOCAL, TANKS_BASELINE = 1.2, 6.0
# eval --exact (the kernels in f32) against the plain f32 forward: the
# kernels sum in other orders than the plain versions (REL_TOL f32 1e-4 a
# kernel); depth error over the depth range and confidence, ~40x below the
# bf16 forward gate
EXACT_BOUNDS = {"depth median": 1e-4, "depth p95": 1e-3,
                "confidence mean |diff|": 1e-4}
# fusion: an 11-view synthetic DTU scan at the eval size, GT depth of the
# plane z = 600 + 0.05 x with unit confidence. Each backend's cloud holds at
# least FUSION_MIN_SHARE of the pixels and lies on the plane: residual
# median and 99th percentile within FUSION_SURFACE world units (a pixel
# spans 600 / 320 = 1.9 there). The card's masks equal the CPU's but at
# ties (tests/_fusion_scenes.py: a compared quantity within TIE, relative,
# of its threshold, at most MAX_TIE_SHARE of the entries)
FUSION_VIEWS, FUSION_PLANE, FUSION_MIN_SHARE = 11, (600.0, 0.05), 0.5
FUSION_SURFACE = (0.1, 0.5)
# the metric's scan: smaller, so that the host KD-tree takes seconds; Acc,
# Comp and Overall of a GT-depth cloud under the pixel footprint
METRIC_SIZE, METRIC_BOUND = (296, 400), 1.5
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
# each chain call that the chain kernel takes is read this many times on
# each route in turn (device_ms), and the rule's route (conv_kernel
# chain_route) must be the faster one: the median of the rounds' ratios of
# its device time to the other route's at most 1
CHAIN_ROUNDS = 7
# the final tile at which the kernel phase runs a chain call on the chain
# kernel where the rule leaves it per layer (the trunk takes its tile in
# conv_kernel.CHAIN_FUSED): the tile that ran it fastest (--chain-tiles)
CHAIN_CASE_TILES = {"x3": (8, 16), "refine": (16, 16)}
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
        source=_SRC + "conv_chain.cu",
        replaces="mdfnet_tpu/ops/pallas/conv2d_kernel.py:654"),
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
# K6 in eval: the variance aggregate's warp (ModelConfig(aggregate_impl=
# "variance")); its launches are that config's bf16 forward's in the
# alternatives phase
ALT_KERNELS = {"sample_2d_eval": dict(
    source=_SRC + "sample_2d.cu",
    replaces="mdfnet_tpu/ops/pallas/warp_kernel.py:143")}
# K6 and K7 at C/G != 2: the vector aggregate of ModelConfig(ngroups=(16,
# 8, 4)) warps each source's C channels a launch in training; their
# launches are the alternatives phase's train step of that config
GROUPS_KERNELS = {
    "sample_2d_groups": dict(
        source=_SRC + "sample_2d.cu",
        replaces="mdfnet_tpu/ops/pallas/warp_kernel.py:143",
        counter="sample_2d"),
    "splat_2d_groups": dict(
        source=_SRC + "splat_2d.cu",
        replaces="mdfnet_tpu/ops/pallas/splat_kernel.py:129",
        counter="splat_2d")}
# the alternatives phase's configurations (the units of JAX core.py:78-132,
# 203-238, each alone and all four together; the vector aggregate at C/G = 4
# at every stage, JAX aggregate.py:291-365), at the DTU eval shape
ALT_CONFIGS = {"variance": dict(aggregate_impl="variance"),
               "atv": dict(hypo_impl="atv"),
               "refine1": dict(refine_impl="refine1"),
               "gauss0": dict(curve_classes=(None, "gauss0", "gauss0")),
               "all four": dict(aggregate_impl="variance", hypo_impl="atv",
                                refine_impl="refine1",
                                curve_classes=(None, "gauss0", "gauss0")),
               "groups": dict(ngroups=(16, 8, 4))}
# the alternatives that also take one train step at DTU train
ALT_TRAIN = ("all four", "groups")
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
# f32 kernels vs plain f32 differ by summation order only, which a
# gradient that cancels amplifies: a DepthWeight BN bias (true gradient ~0)
# reads a plain relative error of 0.122 in one correct order (K1's
# butterfly field, fused step) against 0.042 in this tree. So each
# parameter's error is taken relative to the larger of its own gradient's
# norm and F32_LAYER_SHARE of its layer's (f32_gate_metrics): the worst
# correct reading is then 2.4e-2, a parameter the conv itself rounds, and
# every injected fault still reads >= 3.4 there. Each bound is at least 2x
# the worst reading over equally correct orders (this tree, all direct,
# kFlush 3 / 27 / unflushed, K1 butterfly, co1 chunks outermost) and at
# most half of each fault it is there to catch (``python3 chip_smoke.py
# --gate-spread``, PERF.md section 2); the loss is blind to K6's fault in
# the fused step (its backward only), which the gradients see.
F32_LAYER_SHARE = 0.1
STEP_BOUNDS_F32 = {"loss": 1e-5, "grad rel err": 0.2,
                   "median grad rel err": 3e-3, "1 - min cos": 1e-3}
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


# The stats kernel's (K9): q's G sigmoids once per pixel, per (pixel,
# plane, source) p's G sigmoids and the projection's two divisions.
def stats_mufu(pixels: int, points: int, n_src: int, g: int) -> int:
    return pixels * 2 * g + points * n_src * (2 * g + 2)


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


def k1_inputs(gen, scene, dt, height=HEIGHT, width=WIDTH, nviews=NVIEWS):
    """K1's arguments at the three eval stages of a ``height`` x ``width``
    x ``nviews`` forward (the DTU eval's: S = 4 sources; stage 0 uniform
    planes, stages 1-2 per-pixel planes), drawn from ``gen``."""
    from mdfnet_tpu_torch import geometry

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(DEV)

    intr = torch.from_numpy(scene.intrinsics)[None].to(DEV)
    extr = torch.from_numpy(scene.extrinsics)[None].to(DEV)
    stages = []
    for stage, (d, g) in enumerate(zip(NDEPTHS, NGROUPS)):
        h, w = height >> (3 - stage), width >> (3 - stage)
        ref_proj, src_projs = geometry.projection_matrices(
            intr, extr, stage, num_stages=4)
        if stage == 0:
            hyp = torch.linspace(*DEPTH_RANGE, d).reshape(1, d, 1, 1)
        else:
            hyp = 560.0 + torch.arange(d).reshape(1, d, 1, 1) * 4.0 \
                + torch.rand(1, 1, h, w, generator=gen) * 40.0
        src = rnd(1, nviews - 1, h, w, g).to(dt)
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


def k7_inputs(batch, stress: bool = False):
    """K7's arguments at the three DTU train stages (planes, groups) = (48,
    32), (24, 16), (8, 8) at 1/8, 1/4 and 1/2 of 640x512: the cotangents
    of all 4 sources of 4 items (16 images; stage 0 uniform planes, stages
    1-2 per-pixel planes), from a seeded CUDA generator so that two
    checkouts read the same inputs in one call. Yields (stage, dtype, (g, x,
    y, h, w)), bf16 then f32 at each stage. ``stress``: stage 0 only, on
    the batch's cameras with source view i turned by i x 20 degrees about
    its y axis and planes from 0.2x the near to 5x the far depth."""
    from mdfnet_tpu_torch.ops.warp import sweep_sample_coords
    gen = torch.Generator(device=DEV).manual_seed(10)
    for stage, d, g, h, w, src_projs, ref_proj, hyp in train_sweeps(
            batch, gen, stress):
        x, y = sweep_sample_coords(src_projs, ref_proj, hyp, h, w)
        gr = torch.randn(TRAIN_BATCH * (NVIEWS - 1), d, h, w, g,
                         generator=gen, device=DEV)
        for dt in (torch.bfloat16, torch.float32):
            yield stage, dt, (gr.to(dt), x, y, h, w)
        del gr


def train_sweeps(batch, gen, stress: bool = False):
    """The plane sweeps of the three DTU train stages: (stage, planes,
    groups, h, w, src_projs, ref_proj, hypotheses) with (planes, groups) =
    (48, 32), (24, 16), (8, 8) at 1/8, 1/4 and 1/2 of 640x512 on the batch's
    cameras; stage 0 uniform planes (B, D, 1, 1), stages 1-2 per-pixel
    planes (B, D, H, W) drawn from ``gen`` (a CUDA generator). ``stress``:
    stage 0 only, with source view i turned by i x 20 degrees about its y
    axis and planes from 0.2x the near to 5x the far depth, so that the
    sources are partly out of view."""
    from mdfnet_tpu_torch import geometry
    b = TRAIN_BATCH
    extr = batch["extrinsics"].float()
    if stress:
        extr = extr.clone()
        for i in range(NVIEWS):
            c, sn = (math.cos(math.radians(20.0 * i)),
                     math.sin(math.radians(20.0 * i)))
            yaw = torch.tensor([[c, 0, sn, 0], [0, 1, 0, 0], [-sn, 0, c, 0],
                                [0, 0, 0, 1]], device=extr.device)
            extr[:, i] = yaw @ extr[:, i]
    for stage, (d, g) in enumerate(zip(NDEPTHS, NGROUPS)):
        if stress and stage:
            break
        h, w = TRAIN_HEIGHT >> (3 - stage), TRAIN_WIDTH >> (3 - stage)
        ref_proj, src_projs = geometry.projection_matrices(
            batch["intrinsics"].float(), extr, stage, num_stages=4)
        if stress:
            hyp = torch.linspace(0.2 * DEPTH_RANGE[0], 5.0 * DEPTH_RANGE[1],
                                 d, device=DEV).reshape(1, d, 1, 1)
        elif stage == 0:
            hyp = torch.linspace(*DEPTH_RANGE, d, device=DEV).reshape(
                1, d, 1, 1)
        else:
            hyp = 560.0 + torch.arange(d, device=DEV).reshape(1, d, 1, 1) \
                * 4.0 + torch.rand(b, 1, h, w, generator=gen,
                                   device=DEV) * 40.0
        yield (stage, d, g, h, w, src_projs, ref_proj,
               hyp.expand(b, d, *hyp.shape[2:]))


def k9_inputs(batch, stress: bool = False):
    """The fused train aggregate's arguments (K9) at the three DTU train
    stages (train_sweeps), from a seeded CUDA generator so that two
    checkouts read the same inputs in one call: yields (stage, dtype,
    (src diffs, ref diffs, src_projs, ref_proj, hypotheses, k0), (bn_s,
    bn_o, k1, b1)), bf16 then f32 at each stage, all 4 sources of 4 items.
    ``stress``: stage 0 on the stress cameras of train_sweeps."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    b, s = TRAIN_BATCH, NVIEWS - 1
    for stage, d, g, h, w, src_projs, ref_proj, hyp in train_sweeps(
            batch, gen, stress):
        src = torch.randn(b, s, h, w, g, generator=gen, device=DEV)
        ref = torch.randn(b, h, w, g, generator=gen, device=DEV)
        k0 = torch.randn(g, generator=gen, device=DEV) * 0.3
        bn = (torch.rand(s, generator=gen, device=DEV) + 0.5,
              torch.randn(s, generator=gen, device=DEV) * 0.2,
              torch.tensor(1.2, device=DEV), torch.tensor(-0.2, device=DEV))
        for dt in (torch.bfloat16, torch.float32):
            yield (stage, dt, (src.to(dt), ref.to(dt), src_projs, ref_proj,
                               hyp.contiguous(), k0), bn)


def chain_calls(dt):
    """The eval forward's chain calls (K5) at DTU eval, drawn from their own
    generator: (name, x, weights, scales, offsets, ReLUs, residuals, final
    stride) for the trunk (3 -> 8 -> 8 -> 16, 5x5 stride-2 tail), the
    same-scale pairs at 16, 32 and 64 channels, and refine's half-res stack
    (three Res blocks with the 0.1 scale, conv1 plus conv0's skip, 8 ->
    32)."""
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(DEV)

    def epi(co):
        return rnd(co, scale=0.2).abs() + 0.5, rnd(co, scale=0.1)
    h2, w2 = HEIGHT // 2, WIDTH // 2
    calls = []
    specs = ((3, 3, 8), (3, 8, 8), (5, 8, 16))
    es = [epi(co) for _, _, co in specs]
    calls.append(("trunk", rnd(NVIEWS, HEIGHT, WIDTH, 3).to(dt),
                  [rnd(co, ci, k, k, scale=1.0 / (k * ci ** 0.5)).to(dt)
                   for k, ci, co in specs], [e[0] for e in es],
                  [e[1] for e in es], (True,) * 3, (None,) * 3, 2))
    for name, c, div in (("x2", 16, 2), ("x3", 32, 4), ("x4", 64, 8)):
        es = [epi(c), epi(c)]
        calls.append((name, rnd(NVIEWS, HEIGHT // div, WIDTH // div, c)
                      .to(dt), [rnd(c, c, 3, 3, scale=1.0 / (3 * c ** 0.5))
                                .to(dt) for _ in range(2)],
                      [e[0] for e in es], [e[1] for e in es], (True,) * 2,
                      (None,) * 2, 1))
    ones8 = torch.ones(8, device=DEV)
    calls.append(("refine", rnd(1, h2, w2, 1).to(dt),
                  [rnd(8, 1, 3, 3, scale=0.3).to(dt)]
                  + [rnd(8, 8, 3, 3, scale=0.2).to(dt) for _ in range(7)]
                  + [rnd(32, 8, 3, 3, scale=0.2).to(dt)],
                  [ones8] + [ones8, ones8 * 0.1] * 3
                  + [ones8, torch.ones(32, device=DEV)],
                  [torch.zeros(8, device=DEV)] * 8
                  + [torch.zeros(32, device=DEV)],
                  (False,) + (True, False) * 3 + (False, False),
                  (None, None, 0, None, 2, None, 4, 0, None), 1))
    return calls


@contextlib.contextmanager
def chain_tile(key: tuple, tile: tuple | None):
    """conv_kernel.CHAIN_FUSED with ``key`` (specs, ReLUs, residuals, final
    stride) at ``tile`` (None: as it is) while the block runs, so the
    chain kernel takes a chain that the rule leaves per layer."""
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    fused = conv_kernel.CHAIN_FUSED
    saved = fused.get(key)
    if tile:
        fused[key] = tile
    try:
        yield
    finally:
        if saved is None:
            fused.pop(key, None)
        else:
            fused[key] = saved


def chain_meta(call, x, ws, sc, of, relus, res, fs) -> dict:
    """A chain case's meta: the bytes of its input and weights, its
    products, the tile its case runs the chain kernel at (``tile``: the
    rule's in CHAIN_FUSED, else CHAIN_CASE_TILES'; None where the kernel
    takes no such chain: the case then runs the per-layer route), the
    rule's route (conv_kernel.chain_route), the same convs on cuDNN in a
    row as the yardstick and the chain on the per-layer route beside it.
    Bf16 only: an f32 chain always takes the per-layer route."""
    import torch.nn.functional as F
    from mdfnet_tpu_torch.ops.cuda.conv_kernel import (CHAIN_FUSED,
                                                       chain_plan,
                                                       chain_route,
                                                       conv2d_chain)
    specs = tuple((w.shape[-1], w.shape[1], w.shape[0]) for w in ws)
    key = (specs, relus, res, fs)
    n, h, w = x.shape[:3]
    ops = sum(conv_ops(n * (-(-h // s)) * (-(-w // s)), k * k, ci, co)
              for (k, ci, co), s in zip(specs, [1] * (len(specs) - 1) + [fs]))

    def library(x=x, ws=[cl_weight(v) for v in ws]):
        v = cl(x)
        for i, wt in enumerate(ws):
            v = F.conv2d(v, wt, stride=fs if i == len(ws) - 1 else 1,
                         padding=wt.shape[-1] // 2)
        return v
    tile = CHAIN_FUSED.get(key) or CHAIN_CASE_TILES.get(call)
    if not (x.dtype == torch.bfloat16 and tile and chain_plan(*key, tile)):
        tile = None
    return dict(call=call, in_bytes=size(x, *ws), ops=ops, library=library,
                route=chain_route(x.dtype, *key), key=key, tile=tile,
                layers=lambda: conv2d_chain(x, ws, sc, of, relu_flags=relus,
                                            residuals=res, final_stride=fs,
                                            route="layers"))


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
        # K4 — backbone conv23_0 (5x5 stride 2), the top-down path's last
        # composed 1x1 (out2 lat2 differenced, 16 -> 8, the upsampled addend
        # as its residual), refine's C->1 tail (f32 out)
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
        w1 = rnd(8, 16, 1, 1, scale=0.2).to(dt)
        r1 = rnd(NVIEWS, h2, w2, 8).to(dt)
        cases.append(("conv2d_bn_act", dt, lambda p, x=x, wt=w1, r=r1,
                      e=epi(8): conv2d_bn_act(x, wt, *e, relu=False,
                                              residual=r, plain=p), None))
        # refine's C -> 1 tail on the co1 kernel
        xt = rnd(1, HEIGHT, WIDTH, 8).to(dt)
        wt1 = rnd(1, 8, 3, 3, scale=0.2).to(dt)
        cases.append(co1_case(xt, wt1, epi(1), conv2d_bn_act))
        # K5 — the forward's chain calls (chain_calls), each on the rule's
        # route (conv_kernel.chain_route) beside the per-layer route; the
        # yardstick is the same cuDNN convs in a row; f32 chains take the
        # per-layer route (the trunk and refine's stack, untimed)
        for call, x, ws, sc, of, relus, res, fs in chain_calls(dt):
            if dt == torch.float32 and call not in ("trunk", "refine"):
                continue
            meta = chain_meta(call, x, ws, sc, of, relus, res, fs)

            def chain_case(p, x=x, ws=ws, sc=sc, of=of, relus=relus,
                           res=res, fs=fs, meta=meta):
                with chain_tile(meta["key"], meta["tile"]):
                    return conv2d_chain(
                        x, ws, sc, of, relu_flags=relus, residuals=res,
                        final_stride=fs, plain=p,
                        route="fused" if meta["tile"] else "layers")
            cases.append(("conv2d_chain", dt, chain_case, meta))
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
    return cases + k6_eval_cases(scene)


def k6_eval_cases(scene):
    """K6 in eval: the variance aggregate's warp of one source view's
    C-channel features at DTU eval stage 0 (48 uniform planes, 148x200, C =
    64) and stage 2 (8 per-pixel planes, 592x800, C = 16), bf16 and f32;
    the yardstick is grid_sample on the same samples. Its own generator
    keeps the other cases' inputs as they were."""
    import torch.nn.functional as F
    from mdfnet_tpu_torch import geometry
    from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d
    from mdfnet_tpu_torch.ops.warp import sweep_sample_coords
    gen = torch.Generator().manual_seed(6)
    intr = torch.from_numpy(scene.intrinsics)[None].to(DEV)
    extr = torch.from_numpy(scene.extrinsics)[None].to(DEV)
    chs = (64, 32, 16)      # the backbone's C at stages 0-2
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for stage in (0, 2):
            d, c = NDEPTHS[stage], chs[stage]
            h, w = HEIGHT >> (3 - stage), WIDTH >> (3 - stage)
            ref_proj, src_projs = geometry.projection_matrices(
                intr, extr, stage, num_stages=4)
            if stage == 0:
                hyp = torch.linspace(*DEPTH_RANGE, d).reshape(1, d, 1, 1)
            else:
                hyp = 560.0 + torch.arange(d).reshape(1, d, 1, 1) * 4.0 \
                    + torch.rand(1, 1, h, w, generator=gen) * 40.0
            x, y = sweep_sample_coords(src_projs[:, :1], ref_proj,
                                       hyp.to(DEV), h, w)
            img = torch.randn(1, h, w, c, generator=gen).to(DEV, dt)
            grid = torch.stack([(2.0 * x + 1.0) / w - 1.0,
                                (2.0 * y + 1.0) / h - 1.0], -1)
            meta = dict(in_bytes=size(img, x, y), ops=x.numel() * (10 + 9 * c),
                        kernel="sample_2d_kernel",
                        library=lambda img=cl(img), gd=grid.reshape(
                            1, d, h * w, 2).to(dt): F.grid_sample(
                                img, gd, mode="bilinear",
                                padding_mode="zeros", align_corners=False))
            cases.append(("sample_2d_eval", dt, lambda p, img=img, x=x, y=y:
                          sample_2d(img, x, y, plain=p), meta))
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
    if "layers" in meta:   # a chain: its call, the rule's route, both routes
        case.update(call=meta["call"], rule=meta["route"],
                    kernel=meta["tile"] is not None,
                    tile=meta["tile"] and list(meta["tile"]),
                    library_device_ms=device_ms(meta["library"]),
                    layers_ms=cuda_ms(meta["layers"]))
        # both routes' device times read in turn (the order alternating),
        # their medians and the median of the rounds' ratios
        reads = {"fused": [], "layers": []}
        for r in range(CHAIN_ROUNDS if case["kernel"] else 1):
            for route in (("fused", "layers") if r % 2 == 0
                          else ("layers", "fused")):
                if route == "layers":
                    reads[route].append(device_ms(meta["layers"]))
                elif case["kernel"]:
                    reads[route].append(device_ms(lambda: fn(False)))
        case["layers_device_ms"] = statistics.median(reads["layers"])
        case["device_ms"] = (statistics.median(reads["fused"])
                             if case["kernel"] else case["layers_device_ms"])
        if case["kernel"]:
            case["fused_over_layers"] = statistics.median(
                f / v for f, v in zip(reads["fused"], reads["layers"]))
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
            # the chain kernel's entry: the first call the rule gives it
            if "ms" not in entry and (name != "conv2d_chain"
                                      or case["rule"] == "fused"):
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
            elif "layers_ms" in case:
                line += (f"; {case['call']}, the rule's route "
                         f"{case['rule']}; device time (median of "
                         f"{CHAIN_ROUNDS} in turn): chain kernel "
                         + (f"{case['device_ms']:.3f} ms at "
                            f"{case['tile'][0]}x{case['tile'][1]}"
                            if case["kernel"] else "(takes no such chain)")
                         + f", per-layer route {case['layers_device_ms']:.3f}"
                         f" ms (wall {case['layers_ms']:.3f})"
                         + (f", ratio {case['fused_over_layers']:.4f}"
                            if case["kernel"] else "")
                         + f", library {case['library_device_ms']:.3f} ms")
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
        if case.get("kernel"):
            # the rule's route / the other's, by the median of the rounds
            ratio = case["fused_over_layers"]
            if case["rule"] == "layers":
                ratio = 1.0 / ratio
            require(ratio <= 1.0,
                    f"conv2d_chain {case['call']}: the rule's route "
                    f"{case['rule']} takes {ratio:.4f}x the other's device "
                    f"time (chain kernel {case['device_ms']:.4f} ms, per "
                    f"layer {case['layers_device_ms']:.4f} ms)")
    return report


def tc_sums() -> None:
    """How near the exact sums the tc kernels' f32 sums come, against the
    direct kernel's: bf16 inputs at K2's, K3's and K4's main-path shapes and
    at the chain kernel's two heads (Ci = 3, 1), f32 output, mean |y -
    exact| / mean |exact| with the exact conv in f64 (the tc kernels add
    their tensor-core partial sums in f32 every few K steps, csrc/wgmma.cuh
    kFlush)."""
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
    # the chain kernel's packed heads (K = 48 and 16 on the tensor cores),
    # each launched alone as a one-layer segment writing f32 (chain_plan
    # gives no such segment: no chain of the model runs one), at the
    # trunk's and refine's inputs
    for name, shape in (("K5 head Ci=3", (NVIEWS, HEIGHT, WIDTH, 3)),
                        ("K5 head Ci=1", (1, HEIGHT // 2, WIDTH // 2, 1))):
        x = torch.randn(*shape, generator=gen).to(DEV, torch.bfloat16)
        w = (torch.randn(8, shape[-1], 3, 3, generator=gen) * 0.3).to(
            DEV, torch.bfloat16)
        one, zero = torch.ones(8, device=DEV), torch.zeros(8, device=DEV)
        exact = F.conv2d(cl(x).double(), w.double(), padding=1).movedim(1, -1)
        seg = conv_kernel._chain_segment(((3, shape[-1], 8),), (False,),
                                         (None,), 1, 32, 32)
        fused = conv_kernel._chain_launch(
            x, [w], [one], [zero], seg._replace(first=0, last=0),
            final_stride=1, out_dtype=torch.float32)
        direct = conv_kernel.conv2d_bn_act(x, w, one, zero, relu=False,
                                           out_dtype=torch.float32,
                                           route="direct")
        tc, dr = (((y.double() - exact).abs().mean() / exact.abs().mean())
                  .item() for y in (fused, direct))
        parts.append(f"{name} tc {tc:.2e}, direct {dr:.2e}")
        require(tc <= 1.5 * dr, f"{name}: the chain head's sums are less "
                f"exact than the direct kernel's ({tc:.2e} vs {dr:.2e})")
        del x, exact, fused, direct
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


def forward_gate(model, plain_model, args) -> dict:
    """The forward gate (PERF.md section 2): the kernel forward against the
    plain f32 forward on the card on the same inputs: depth error over the
    depth range (median, p95, max), confidence, and each stage's cost and
    probability volumes (FORWARD_BOUNDS); "line" says it in words."""
    out, vols = stage_volumes(model, args, plain=False)
    t0 = time.perf_counter()
    ref, ref_vols = stage_volumes(plain_model, args, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    h, w = args[0].shape[2:4]
    depth, ref_depth = out["depth"].float(), ref["depth"].float()
    conf = out["confidence"].float()
    require(depth.shape == (1, h, w) and conf.shape == depth.shape,
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
    line = (f"depth err median {med:.2e} p95 {p95:.2e} max {err.max():.2e} "
            f"of range; " + ", ".join(
                f"{k} {v:.2e} (bound {FORWARD_BOUNDS[k]:.1e})"
                for k, v in diffs.items())
            + f"; mean peak probability per stage {peaks} (flat: "
            f"{[round(1 / d, 4) for d in NDEPTHS]})")
    return dict(median=med, p95=p95, diffs=diffs, plain_s=plain_s,
                line=line)


def require_gate(gate: dict, what: str) -> None:
    require(gate["median"] <= MEDIAN_BOUND and gate["p95"] <= P95_BOUND,
            f"{what}: depth disagrees with the plain f32 forward")
    for k, v in gate["diffs"].items():
        require(v <= FORWARD_BOUNDS[k],
                f"{what}: {k} {v:.2e} > {FORWARD_BOUNDS[k]:.1e}")


def reset_launches() -> None:
    """Every eval kernel's launch count (and the tc kernel's per wrapper)
    to 0."""
    from mdfnet_tpu_torch.ops.cuda import (aggregate_kernel, conv_kernel,
                                           warp_kernel)
    for c in (aggregate_kernel.LAUNCHES, conv_kernel.LAUNCHES,
              conv_kernel.TC_LAUNCHES, warp_kernel.LAUNCHES):
        for k in c:
            c[k] = 0


def launches_by_route(model) -> tuple[dict, dict]:
    """The conv launches since reset_launches by route (the chain, tc, co1
    and direct kernels), and what the route rule gives for one eval forward
    of ``model`` (eval_conv_routes)."""
    from mdfnet_tpu_torch.models.conv_routes import eval_conv_routes
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    counts = conv_kernel.LAUNCHES
    ran = {"chain": counts["conv2d_chain"], "tc": counts["conv_tc"],
           "co1": counts["conv_co1"]}
    ran["direct"] = sum(counts[k] for k in ("conv3d_bn_act",
                                            "trconv3d_bn_act",
                                            "conv2d_bn_act")) \
        - ran["tc"] - ran["co1"]
    routes = eval_conv_routes(model)
    return ran, {r: routes.count(r) for r in ran}


def eval_launches(model, what: str) -> tuple[dict, dict, dict]:
    """The launches of one eval forward since reset_launches: every kernel
    of the path launched, and each once per conv and transposed conv that
    the rule sends to it, from the model's layers: the chain kernel once
    per fused chain (conv_kernel.chain_route), the tc kernel, the co1
    kernel (the ProbConvs, refine's tail) and the direct kernel (the Ci = 3
    and 1 heads of the chains on the per-layer route); none of the
    transposed convs on the direct kernel. Returns (launches per wrapper,
    launches per route, tc launches per wrapper)."""
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel, conv_kernel
    # the eval path's kernels (the *_dgrad counters belong to training)
    launches = {k: v for c in (aggregate_kernel.LAUNCHES,
                               conv_kernel.LAUNCHES)
                for k, v in c.items() if k in KERNELS}
    tc = {k: conv_kernel.TC_LAUNCHES[k] for k in launches
          if k in conv_kernel.TC_LAUNCHES}
    require(all(v > 0 for v in launches.values()),
            f"a kernel of {what} never launched: {launches}")
    ran, rule = launches_by_route(model)
    require(ran == rule and min(ran[r] for r in ("chain", "tc", "co1")) > 0,
            f"{what}: launches by route {ran}, the rule gives {rule}")
    require(launches["trconv3d_bn_act"] == tc["trconv3d_bn_act"],
            f"{what}: a transposed conv left the tc kernel: {launches}, "
            f"tc {tc}")
    return launches, rule, tc


def forward_phase(build_s, scene):
    from mdfnet_tpu_torch.data import make_batch
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.ops.cuda import conv_kernel

    model = build_model(compute_dtype="bfloat16", seed=0, device=DEV)
    sharpen(model)
    plain_model = build_model(seed=0, device=DEV)
    plain_model.load_state_dict(model.state_dict())
    batch = make_batch(scene, batch=1)
    args = [torch.from_numpy(batch[k]).to(DEV)
            for k in ("imgs", "extrinsics", "intrinsics", "depth_range")]

    reset_launches()
    conv_kernel.TRACE = traced = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    conv_kernel.TRACE = None
    launches, rule, tc = eval_launches(model, "the main path")
    # the backbone's linearised top-down path: three composed 1x1 convs
    top_down = [t for t in traced if t[2] == 1]
    print(f"routes: {rule} launches per forward, as the rule gives for the "
          f"model's chains, convs and transposed convs "
          f"({sum(rule.values())} launches); tc per wrapper {tc}; the "
          f"top-down path's 1x1 launches (route, x, Co): "
          f"{[(t[0], t[4], t[5]) for t in top_down]}", flush=True)
    require(len(top_down) == 3 and all(t[0] == "tc" for t in top_down),
            f"the top-down path made {len(top_down)} 1x1 launches, not "
            f"three on the tc kernel: {top_down}")

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

    gate = forward_gate(model, plain_model, args)
    print(f"forward {WIDTH}x{HEIGHT}x{NVIEWS} bf16: {ms_map:.2f} ms/map (median of "
          f"{len(times) - 1}; runs {[round(t, 2) for t in times]}), first map "
          f"{first_s:.2f} s + build {build_s:.1f} s, peak "
          f"{peak_mb:.0f} MiB; vs plain f32 ({gate['plain_s']:.2f} s): "
          + gate["line"] + f"; launches {launches}", flush=True)
    require_gate(gate, "bf16 kernel forward")
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


def glue_ms(split: dict) -> dict:
    """ATen's elementwise and ``cat`` kernels' device ms in a device_split."""
    return {"elementwise": sum(v for k, v in split.items()
                               if "elementwise_kernel" in k),
            "cat": sum(v for k, v in split.items()
                       if "CatArrayBatchedCopy" in k)}


def profile_phase(model, args, ms_map) -> dict:
    """Where one forward's time goes: device time by kernel (torch.profiler,
    CUPTI), ATen's elementwise and ``cat`` kernels among it (per forward,
    over 3), and by layer (CUDA events around the top-level modules), which
    it returns.

    The idle share is measured within the profiled forward, whose host time
    the profiler inflates; the share of an unprofiled forward is estimated
    from this forward's device time and ``ms_map``, the median host time of
    the unprofiled forwards of the same run."""
    busy, wall_us, top = device_profile(lambda: model(*args), 12)
    glue = glue_ms(device_split(lambda: model(*args), iters=3))
    print(f"profile: device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"wall of the profiled forward (idle {1 - busy / wall_us:.1%}); "
          f"estimated idle of an unprofiled forward (vs its median "
          f"{ms_map:.2f} ms) {1 - busy / 1e3 / ms_map:.1%}; ATen elementwise "
          f"{glue['elementwise']:.3f} ms, cat {glue['cat']:.3f} ms device a "
          f"forward; top: {top}", flush=True)
    layers, total = layer_ms(model, args)
    print("layers (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      layers.items())
          + f", other {total - sum(layers.values()):.2f}, total {total:.2f}",
          flush=True)
    return layers


def layer_ms(model, args) -> tuple[dict, float]:
    """One forward's time by top-level layer (CUDA events around each
    module) and in all, ms."""
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
    return ({k: a.elapsed_time(b) for k, (a, b) in events.items()},
            start.elapsed_time(end))


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


def alt_launches(model, what: str) -> dict:
    """The launches of one eval forward of an alternatives config since
    reset_launches: the aggregate's kernel (K6, one launch a source, at a
    stage of the variance aggregate or of the vector aggregate at C/G != 2;
    K1, one launch, at a stage of the vector aggregate at C/G == 2), and
    every conv on the kernel the rule gives it (eval_conv_routes; in f32 no
    chain and no tc). Returns the launches per counter."""
    from mdfnet_tpu_torch.models.aggregate_variance import VarianceAggregate
    from mdfnet_tpu_torch.ops.cuda import (aggregate_kernel, conv_kernel,
                                           warp_kernel)
    counts = {k: v for c in (aggregate_kernel.LAUNCHES, conv_kernel.LAUNCHES,
                             warp_kernel.LAUNCHES) for k, v in c.items()}
    want = {"sample_2d": 0, "rowsweep_aggregate": 0}
    outs = (model.Backbone.out4, model.Backbone.out3, model.Backbone.out2)
    for agg, out in zip(model.Homoaggre, outs):
        if isinstance(agg, VarianceAggregate) \
                or out.weight.shape[0] != 2 * agg.ngroups:
            want["sample_2d"] += NVIEWS - 1
        else:
            want["rowsweep_aggregate"] += 1
    require(all(counts[k] == v for k, v in want.items()),
            f"{what}: aggregate launches {counts}, want {want}")
    ran, rule = launches_by_route(model)
    require(ran == rule and ran["co1"] > 0 and ran["direct"] + ran["tc"] > 0,
            f"{what}: launches by route {ran}, the rule gives {rule}")
    return counts


def checked_launches(errs: dict) -> list:
    """Patches under which every conv launch (conv_kernel._launch) also
    runs its plain version on the same inputs: ``errs`` gets, per (route,
    kd, k, stride, transposed, input shape, Co), the largest max |diff|
    over the plain result's max |value| of the launches there."""
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    launch = conv_kernel._launch

    def checked(counter, x5, w_kio, scale, offset, residual, out_dtype,
                **kw):
        y = launch(counter, x5, w_kio, scale, offset, residual, out_dtype,
                   **kw)
        kd, k, stride = kw["kd"], kw["k"], kw["stride"]
        transposed = kw.get("transposed", False)
        ci, co = w_kio.shape[-2:]
        route = kw.get("route") or conv_kernel.conv_route(
            x5.dtype, kd, k, stride, ci, co, transposed)
        nd = w_kio.dim()
        # back to torch's layout: (Ci, Co, *taps) transposed, else (Co, Ci,
        # *taps); a 2D conv's (k, k, Ci, Co) on x (N, 1, H, W, Ci)
        w = w_kio.permute(nd - 2, nd - 1, *range(nd - 2)) if transposed \
            else w_kio.permute(nd - 1, nd - 2, *range(nd - 2))
        x, res = (x5, residual) if kd > 1 else (
            x5[:, 0], None if residual is None else residual[:, 0])
        ref = conv_kernel._conv_plain(
            x, w, scale, offset, stride=stride, relu=kw["relu"],
            residual=res, out_dtype=out_dtype, transposed=transposed)
        ref = ref.float() if kd > 1 else ref.float()[:, None]
        err = (y.float() - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-6)
        key = (route, kd, k, stride, transposed, tuple(x5.shape), co)
        errs[key] = max(errs.get(key, 0.0), rel)
        return y
    return [(conv_kernel, "_launch", checked)]


def alternatives_phase(scene, smi: str) -> tuple[int, dict]:
    """The alternative units (ALT_CONFIGS: the variance aggregate, ATV
    hypotheses, RefineNet v1, gauss0 curves, all four together, and the
    vector aggregate at C/G = 4, whose warp is K6) at the DTU
    eval shape (1600x1184, 5 views, B=1; seeded random weights, sharpened):
    each config's forward on the kernels in f32 against the plain f32
    forward on the card (EXACT_BOUNDS) with its kernels launched
    (alt_launches), then its bf16 forward's launches, ms/map and peak
    memory, the forward gate (FORWARD_BOUNDS) against the plain f32 forward
    and each of its conv launches against its plain version
    (checked_launches, REL_TOL). Then one train step of each config of
    ALT_TRAIN (all four; the vector aggregate at C/G = 4) at the DTU train
    configuration on the kernels in f32 against the plain f32 step
    (STEP_BOUNDS_F32's loss and gradient bounds), with K6, K7 and K8
    launched and a finite loss. Returns K6's launches in the variance
    config's bf16 forward and the C/G = 4 train step's launches."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.data import make_batch
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.ops.cuda import conv_kernel, splat_kernel, warp_kernel
    batch = make_batch(scene, batch=1)
    args = [torch.from_numpy(batch[k]).to(DEV)
            for k in ("imgs", "extrinsics", "intrinsics", "depth_range")]
    k6_launches = 0
    for name, fields in ALT_CONFIGS.items():
        config = ModelConfig(**fields)
        models = {}
        for dtype in ("float32", "bfloat16"):
            models[dtype] = build_model(config, compute_dtype=dtype, seed=0,
                                        device=DEV)
        sharpen(models["float32"])
        models["bfloat16"].load_state_dict(models["float32"].state_dict())
        reset_launches()
        out = models["float32"](*args)
        torch.cuda.synchronize()
        f32_counts = alt_launches(models["float32"], f"{name} f32 forward")
        t0 = time.perf_counter()
        ref = models["float32"](*args, plain=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = ((out["depth"] - ref["depth"]).abs()
               / (DEPTH_RANGE[1] - DEPTH_RANGE[0])).flatten().cpu().numpy()
        got = {"depth median": float(np.median(err)),
               "depth p95": float(np.percentile(err, 95)),
               "confidence mean |diff|": (out["confidence"]
                                          - ref["confidence"]).abs().mean()
               .item()}
        require(bool(torch.isfinite(out["depth"]).all()
                     & torch.isfinite(out["confidence"]).all()),
                f"{name}: the f32 kernel forward is not finite")
        del out, ref
        reset_launches()
        models["bfloat16"](*args)
        torch.cuda.synchronize()
        counts = alt_launches(models["bfloat16"], f"{name} bf16 forward")
        if name == "variance":
            k6_launches = counts["sample_2d"]
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = models["bfloat16"](*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        require(bool(torch.isfinite(out["depth"]).all()),
                f"{name}: the bf16 kernel forward is not finite")
        del out
        gate = forward_gate(models["bfloat16"], models["float32"], args)
        errs = {}
        with patched(checked_launches(errs)):
            models["bfloat16"](*args)
        torch.cuda.synchronize()
        reset_launches()
        tc = {key: rel for key, rel in errs.items() if key[0] == "tc"}
        worst = max(errs, key=errs.get)
        print(f"alternatives {name} bf16 kernels vs plain f32: "
              + gate["line"] + f"; each conv launch vs its plain version "
              f"({len(errs)} shapes, {len(tc)} on tc): worst rel "
              f"{errs[worst]:.3e} at {worst} (tol "
              f"{REL_TOL[torch.bfloat16]:.0e}); tc (kd, k, stride, "
              f"transposed, x, Co): rel "
              + ", ".join(f"{key[1:]}: {rel:.2e}"
                          for key, rel in sorted(tc.items())), flush=True)
        require_gate(gate, f"alternatives {name} bf16 kernel forward")
        for key, rel in errs.items():
            require(rel <= REL_TOL[torch.bfloat16] and math.isfinite(rel),
                    f"alternatives {name}: the {key[0]} launch {key[1:]} "
                    f"disagrees with its plain version: rel {rel:.3e}")
        print(f"alternatives {name} ({fields}) {WIDTH}x{HEIGHT}x{NVIEWS}: "
              f"f32 kernels vs plain f32 ({plain_s:.2f} s): " + ", ".join(
                  f"{k} {v:.2e} (bound {EXACT_BOUNDS[k]:.0e})"
                  for k, v in got.items())
              + f", depth max {err.max():.2e}; f32 launches "
              f"{ {k: v for k, v in f32_counts.items() if v} }; bf16 "
              f"{statistics.median(times[1:]):.2f} ms/map (median of "
              f"{len(times) - 1}; runs {[round(t, 2) for t in times]}), peak "
              f"{peak_mb:.0f} MiB, launches "
              f"{ {k: v for k, v in counts.items() if v} }; {smi}",
              flush=True)
        for k, b in EXACT_BOUNDS.items():
            require(got[k] <= b, f"alternatives {name}: {k} {got[k]:.2e} > "
                    f"{b:.0e}")
        del models

    train = train_batch()
    counters = (warp_kernel.LAUNCHES, splat_kernel.LAUNCHES,
                conv_kernel.LAUNCHES)
    step_kernels = ("sample_2d", "splat_2d", "conv3d_dgrad",
                    "trconv3d_dgrad", "conv2d_dgrad")
    train_counts = {}
    for name in ALT_TRAIN:
        config = ModelConfig(**ALT_CONFIGS[name])
        loss_k, grads_k, _, counts = _step("float32", False, train,
                                           launches=counters, config=config)
        loss_p, grads_p, _, _ = _step("float32", True, train, config=config)
        m32 = f32_gate_metrics(loss_k, f32_param_stats(grads_k, grads_p),
                               loss_p)
        print(f"alternatives {name}, train step {TRAIN_WIDTH}x{TRAIN_HEIGHT}x"
              f"{NVIEWS} batch {TRAIN_BATCH}, f32 kernels vs plain f32 "
              f"({len(grads_p)} parameters): loss {loss_k:.6f} vs "
              f"{loss_p:.6f}; "
              + ", ".join(f"{k} {m32[k]:.2e}" + (
                  f" (bound {STEP_BOUNDS_F32[k]:.1e})"
                  if k in STEP_BOUNDS_F32 else "")
                  for k in m32 if k not in ("worst", "raw worst"))
              + f"; worst {m32['worst']}; launches "
              f"{ {k: counts[k] for k in step_kernels} }; {smi}", flush=True)
        require(math.isfinite(loss_k),
                f"alternatives {name} train step: loss {loss_k}")
        require(all(counts[k] > 0 for k in step_kernels),
                f"alternatives {name} train step: a kernel never launched: "
                f"{counts}")
        for k, b in STEP_BOUNDS_F32.items():
            require(m32[k] <= b, f"alternatives {name} train step: {k} "
                    f"{m32[k]:.2e} > {b:.1e} ({m32['worst']})")
        train_counts[name] = counts
        del grads_k, grads_p
    return k6_launches, train_counts["groups"]


# ------------------------------------ Tanks & Temples, fusion and the metric


def smoke_dir(name: str) -> str:
    """An empty scratch directory under the checkout's git-ignored build/."""
    path = os.path.join(ROOT, "build", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def tanks_scene(width: int, height: int = TANKS_HEIGHT):
    """A Tanks-size synthetic scene: a textured tilted plane seen by 11
    cameras in a row (10 sources to one side of the reference)."""
    from mdfnet_tpu_torch.data import make_plane_scene
    return make_plane_scene(height=height, width=width, nviews=TANKS_NVIEWS,
                            tilt=0.05, focal=TANKS_FOCAL * width,
                            baseline=TANKS_BASELINE)


def tanks_phase(model, smi: str) -> None:
    """The eval forward at the Tanks shapes (11 views, 1920x1056 and
    2048x1056): K1 against its plain version at the three stages (S = 10),
    in bf16 and f32; the bf16 kernel forward with every kernel of the path
    launched (counts set to 0 just before, read just after), its ms per
    map, peak memory and the forward gate, then its device busy time and
    time by layer (profile_phase)."""
    from mdfnet_tpu_torch.data import make_batch
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel

    plain_model = build_model(seed=0, device=DEV)
    plain_model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(12)
    for width in TANKS_WIDTHS:
        scene = tanks_scene(width)
        k1 = []
        for dt in (torch.bfloat16, torch.float32):
            for stage, a in enumerate(k1_inputs(gen, scene, dt, TANKS_HEIGHT,
                                                width, TANKS_NVIEWS)):
                got = aggregate_kernel.rowsweep_aggregate(*a)
                ref = aggregate_kernel.rowsweep_aggregate(*a, plain=True)
                rel = ((got.float() - ref.float()).abs().max().item()
                       / max(ref.float().abs().max().item(), 1e-6))
                ms = (kernel_device_ms(
                    lambda a=a: aggregate_kernel.rowsweep_aggregate(*a),
                    "rowsweep_aggregate_kernel") if dt == torch.bfloat16
                    else None)
                k1.append((stage, str(dt)[6:], tuple(got.shape), rel, ms))
                require(rel <= REL_TOL[dt] and math.isfinite(rel),
                        f"K1 at the Tanks stage {stage} ({width} wide, "
                        f"S = {TANKS_NVIEWS - 1}, {dt}) disagrees with its "
                        f"plain version: rel err {rel:.2e}")
        print(f"tanks K1 {width}x{TANKS_HEIGHT}, S = {TANKS_NVIEWS - 1}: "
              + "; ".join(f"stage {s} {dt} {shape} rel err {rel:.2e}"
                          + (f", {ms:.3f} ms device" if ms else "")
                          for s, dt, shape, rel, ms in k1)
              + f" (tol bf16 {REL_TOL[torch.bfloat16]:.0e}, f32 "
              f"{REL_TOL[torch.float32]:.0e}); {smi}", flush=True)

        batch = make_batch(scene, batch=1)
        args = [torch.from_numpy(batch[k]).to(DEV)
                for k in ("imgs", "extrinsics", "intrinsics", "depth_range")]
        reset_launches()
        torch.cuda.synchronize()
        model(*args)
        torch.cuda.synchronize()
        launches, rule, _ = eval_launches(
            model, f"the Tanks forward at {width}x{TANKS_HEIGHT}")
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        ms_map = statistics.median(times[1:])
        gate = forward_gate(model, plain_model, args)
        print(f"tanks forward {width}x{TANKS_HEIGHT}x{TANKS_NVIEWS} bf16: "
              f"{ms_map:.2f} ms/map (median of {len(times) - 1}; runs "
              f"{[round(t, 2) for t in times]}), peak {peak_mb:.0f} MiB; "
              f"vs plain f32 ({gate['plain_s']:.2f} s): " + gate["line"]
              + f"; launches {launches}, by route {rule} as the rule "
              f"gives; {smi}", flush=True)
        require_gate(gate, f"bf16 kernel forward at {width}x{TANKS_HEIGHT}")
        profile_phase(model, args, ms_map)   # device busy time, by layer
        del args, batch
    zbuffer_at_tanks(scene, smi)


def zbuffer_at_tanks(scene, smi: str) -> None:
    """pcd's z-buffer for one reference view at the last Tanks shape (GT
    depths, 10 sources): (1 + S) x H x W candidates and their violation
    counts on the card, their copy to the host, the native election."""
    from mdfnet_tpu_torch.fusion.pcd_fusion import zbuffer_fusion
    d, k, e = scene.depths, scene.intrinsics, scene.extrinsics
    times = {}
    for _ in range(2):   # the first call builds the native library
        times.clear()
        t0 = time.perf_counter()
        fused = zbuffer_fusion(d[0], k[0], e[0], d[1:], k[1:], e[1:],
                               device=DEV, times=times)
        total = time.perf_counter() - t0
    m = d.size
    print(f"tanks zbuffer {d.shape[2]}x{d.shape[1]}, S = {len(d) - 1}: "
          f"{m / 1e6:.1f}M candidates, {m * 16 / 2**20:.0f} MiB copied to "
          f"the host; " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                     times.items())
          + f", {total:.3f} s in all; {int((fused > 0).sum())} of "
          f"{fused.size} pixels elected; {smi}", flush=True)
    require(int((fused > 0).sum()) > fused.size // 2,
            "zbuffer at the Tanks shape elected too few pixels")


def tanks_serve_phase(model, smi: str) -> None:
    """``python -m mdfnet_tpu_torch.cli.eval -d tanks`` on a synthetic Tanks
    tree (a 1920- and a 2048-wide scene of 1080-high images, 11 views, two
    reference views each), then ``--exact`` (the kernels in f32) on one
    view, held to the plain f32 forward of the same item (EXACT_BOUNDS)."""
    from mdfnet_tpu_torch.data import (TanksEvalDataset, read_pair_file,
                                       read_pfm, write_pair_file,
                                       write_tanks_eval_tree)
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.utils.weights import load_checkpoint, save_checkpoint

    work = smoke_dir("smoke_tanks")
    try:
        root = os.path.join(work, "TankandTemples", "intermediate")
        for scene, width in zip(TANKS_SCENES, TANKS_WIDTHS):
            write_tanks_eval_tree(root, scenes=(scene,), nviews=TANKS_NVIEWS,
                                  height=TANKS_IMAGE_HEIGHT, width=width,
                                  tilt=0.05, focal=TANKS_FOCAL * width,
                                  baseline=TANKS_BASELINE)
            pair = os.path.join(root, scene, "pair.txt")
            _, pairs = read_pair_file(pair)
            write_pair_file(pair, [pairs[0], pairs[5]])
        ckpt = os.path.join(work, "seed0.pth")
        save_checkpoint(model, ckpt)

        def cli(out, *extra):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "mdfnet_tpu_torch.cli.eval", "-p", ckpt,
                 "-d", "tanks", "--root", work, "-o", out, *extra],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            log = (proc.stdout + proc.stderr).strip().splitlines()
            require(proc.returncode == 0,
                    "eval CLI (tanks) failed:\n" + "\n".join(log[-30:]))
            return time.perf_counter() - t0, log[-1].split(": ", 1)[-1]

        out = os.path.join(work, "outputs")
        cli_s, last = cli(out, "--scans", ",".join(TANKS_SCENES))
        for scene, width in zip(TANKS_SCENES, TANKS_WIDTHS):
            for ref in (0, 5):
                depth, _ = read_pfm(os.path.join(out, scene, "depth_est",
                                                 f"{ref:08d}.pfm"))
                require(depth.shape == (TANKS_HEIGHT, width)
                        and np.isfinite(depth).all(),
                        f"tanks {scene} view {ref}: depth {depth.shape}")
        print(f"tanks serve: eval CLI -d tanks wrote 4 views "
              f"({'/'.join(TANKS_SCENES)}: "
              f"{'/'.join(map(str, TANKS_WIDTHS))}x{TANKS_HEIGHT}, "
              f"{TANKS_NVIEWS} views) in {cli_s:.1f} s; {last}; {smi}",
              flush=True)

        # --exact on one view, against the plain f32 forward of that item
        pair = os.path.join(root, TANKS_SCENES[0], "pair.txt")
        _, pairs = read_pair_file(pair)
        write_pair_file(pair, pairs[:1])
        exact = os.path.join(work, "exact")
        cli_s, last = cli(exact, "--scans", TANKS_SCENES[0], "--exact")
        got = [read_pfm(os.path.join(exact, TANKS_SCENES[0], sub,
                                     "00000000.pfm"))[0]
               for sub in ("depth_est", "confidence")]
        item = TanksEvalDataset(root, [TANKS_SCENES[0]])[0]
        plain = build_model(seed=1, device=DEV)
        load_checkpoint(plain, ckpt)
        with torch.no_grad():
            ref = plain(*(torch.from_numpy(item[k])[None].to(DEV) for k in (
                "imgs", "extrinsics", "intrinsics", "depth_range")),
                plain=True)
        want = [ref[k][0].float().cpu().numpy()
                for k in ("depth", "confidence")]
        err = np.abs(got[0] - want[0]) / (DEPTH_RANGE[1] - DEPTH_RANGE[0])
        reads = {"depth median": float(np.median(err)),
                 "depth p95": float(np.percentile(err, 95)),
                 "confidence mean |diff|":
                     float(np.abs(got[1] - want[1]).mean())}
        print(f"tanks exact: eval CLI -d tanks --exact (the kernels in f32) "
              f"on one {TANKS_WIDTHS[0]}x{TANKS_HEIGHT} view in "
              f"{cli_s:.1f} s vs the plain f32 forward: "
              + ", ".join(f"{k} {v:.2e} (bound {EXACT_BOUNDS[k]:.0e})"
                          for k, v in reads.items())
              + f", depth err max {err.max():.2e}; {last}; {smi}", flush=True)
        for k, v in reads.items():
            require(v <= EXACT_BOUNDS[k],
                    f"eval --exact: {k} {v:.2e} > {EXACT_BOUNDS[k]:.0e}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_gt_outputs(out: str, scene, scan: str = "scan9") -> None:
    """GT depths and unit confidence in the eval CLI's output schema."""
    from mdfnet_tpu_torch.data import write_pfm
    for sub in ("depth_est", "confidence"):
        os.makedirs(os.path.join(out, scan, sub), exist_ok=True)
    for v, depth in enumerate(scene.depths):
        write_pfm(os.path.join(out, scan, "depth_est", f"{v:08d}.pfm"), depth)
        write_pfm(os.path.join(out, scan, "confidence", f"{v:08d}.pfm"),
                  np.ones_like(depth))


def tie_rule():
    """The fusion tests' tie rule, tests/_fusion_scenes.py (TIE,
    MAX_TIE_SHARE, near, near_integer)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _fusion_scenes
    return _fusion_scenes


def tie_check(name: str, got, want, ties) -> str:
    """``got`` (the card) equals ``want`` (the CPU) but at ties (the tie
    rule of tests/_fusion_scenes.py): an entry that differs must lie where
    ``ties()`` (computed from the CPU's quantities, only when something
    differs) is set, and at most MAX_TIE_SHARE of the entries may
    differ."""
    got, want = np.asarray(got), np.asarray(want)
    require(got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}")
    differ = got != want
    if got.dtype.kind == "f":
        differ &= ~(np.isnan(got) & np.isnan(want))
    n = int(differ.sum())
    if n:
        tie = np.broadcast_to(ties(), differ.shape)
        require(not (differ & ~tie).any(),
                f"{name}: {int((differ & ~tie).sum())} entries differ on "
                f"the card from the CPU away from every threshold")
        require(n <= tie_rule().MAX_TIE_SHARE * differ.size,
                f"{name}: {n} of {differ.size} entries differ")
    return f"{name} {n}/{differ.size}"


def fusion_device_check(scene, smi: str) -> None:
    """One reference view (0, its 10 sources) of the fusion scan through
    each backend's per-view functions on the card, with TF32 allowed, and
    on the CPU: masks and counts equal under the tie rule (the card's
    projections are elementwise f32 with explicit FMAs, so none should
    differ), continuous outputs bit for bit where they do. pcd's
    violation counts are recomputed on the CPU for every 8th candidate."""
    from mdfnet_tpu_torch import geometry
    from mdfnet_tpu_torch.fusion import consistency_vote as vote
    from mdfnet_tpu_torch.fusion import dynamic_filter as filt
    from mdfnet_tpu_torch.fusion import pcd_fusion as pcd
    from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d
    rule = tie_rule()
    near, near_integer = rule.near, rule.near_integer

    d, k, e = (torch.from_numpy(a) for a in (
        scene.depths, scene.intrinsics, scene.extrinsics))
    cpu = (d[0], k[0], e[0], d[1:], k[1:], e[1:])
    card = tuple(a.to(DEV) for a in cpu)
    h, w = d.shape[1:]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    lines, secs = [], {}

    def both(fn, *extra):
        t0 = time.perf_counter()
        on_card = fn(*card, *(x.to(DEV) for x in extra))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        on_cpu = fn(*cpu, *extra)
        secs[fn.__name__] = (t1 - t0, time.perf_counter() - t1)
        return ([x.cpu().numpy() for x in on_card],
                [x.numpy() for x in on_cpu])
    try:
        # filter: the per-rung counts, the strict count, the depth sum
        (cnt, strict, dsum), (cnt_c, strict_c, dsum_c) = both(
            filt.geometric_consistency)

        def filter_ties():
            dre, xre, yre = (x.numpy() for x in filt._reproject(*cpu))
            yy, xx = np.mgrid[0:h, 0:w]
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.abs(dre - cpu[0].numpy()) / cpu[0].numpy()
            steps = np.arange(2, 11, dtype=np.float64)
            return (near(np.hypot(xre - xx, yre - yy), steps / 4)
                    | near(rel, steps / 1300)).any(0)
        lines += [tie_check("filter rung counts", cnt, cnt_c, filter_ties),
                  tie_check("strict count", strict, strict_c, filter_ties),
                  tie_check("depth sum", dsum, dsum_c, filter_ties)]

        # vote: accept, points
        (pts, acc), (pts_c, acc_c) = both(vote.consistency_vote)

        def vote_ties(points: bool):
            """Accept: the disparity difference at its threshold or a
            projection on the border; points: a truncated pixel at an
            integer."""
            xw = geometry.unproject(*(a[None] for a in cpu[:3]))
            xs, ys, dx = geometry.project(xw.expand(10, 3, h * w), *cpu[4:])
            if points:
                return (near_integer(xs.numpy())
                        | near_integer(ys.numpy())).any(0)[:, None]
            ds = bilinear_sample_2d(cpu[3][..., None], xs, ys,
                                    fused=True)[..., 0]
            c = lambda m: -m[..., :3, :3].transpose(-1, -2).double() @ \
                m[..., :3, 3:].double()
            fb = (cpu[1][0, 0].double()
                  * (c(cpu[2])[None] - c(cpu[5])).norm(dim=1))
            with np.errstate(divide="ignore", invalid="ignore"):
                diff = (fb / dx.double() - fb / ds.double()).abs().numpy()
            xs, ys = xs.numpy(), ys.numpy()
            border = (np.minimum(np.abs(xs), np.abs(xs - w)) <= rule.TIE * w) \
                | (np.minimum(np.abs(ys), np.abs(ys - h)) <= rule.TIE * h)
            return (near(diff, [0.25]) | border).any(0)
        lines += [tie_check("vote accept", acc, acc_c,
                            lambda: vote_ties(False)),
                  tie_check("vote points", pts, pts_c,
                            lambda: vote_ties(True))]

        # pcd: the reprojection, the visibility masks, the candidates
        (xr, yr, dr, rng), (xr_c, yr_c, dr_c, rng_c) = both(
            pcd.reproject_all)

        def cell_ties():
            world = pcd._img2world(pcd._centers(h, w), cpu[0].reshape(-1),
                                   *cpu[1:3])
            xs, ys, _ = pcd._world2img(world.expand(10, 3, h * w), *cpu[4:])
            return (near_integer(xs.numpy())
                    | near_integer(ys.numpy())).reshape(10, h, w)
        lines += [tie_check("pcd in range", rng, rng_c, cell_ties)]
        lines += [tie_check(f"pcd reprojected {n}", a, b, cell_ties)
                  for n, a, b in (("x", xr, xr_c), ("y", yr, yr_c),
                                  ("d", dr, dr_c))]
        vis = [x.cpu().numpy() for x in pcd.visibility_masks(
            card[0], *(torch.from_numpy(a).to(DEV)
                       for a in (xr, yr, dr, rng)))]
        vis_c = [x.numpy() for x in pcd.visibility_masks(
            cpu[0], *map(torch.from_numpy, (xr, yr, dr, rng)))]

        def vis_ties():
            yy, xx = np.mgrid[0:h, 0:w] + 0.5
            ref = cpu[0].numpy().astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.abs(ref - dr) / np.maximum(ref, dr)
            return near(np.hypot(xr - xx, yr - yy), [1.0]) | \
                near(rel, [0.01])
        lines += [tie_check("pcd visibility masks", vis[0], vis_c[0],
                            vis_ties),
                  tie_check("pcd visibility vote", vis[1], vis_c[1],
                            lambda: vis_ties().any(0))]
        t0 = time.perf_counter()
        xy, dc, vio, ok = pcd._candidates_and_violations(*card)
        torch.cuda.synchronize()
        secs["candidates"] = (time.perf_counter() - t0, None)
        sub = slice(None, None, 8)
        x_c, y_c, d_c = (a.cpu()[sub] for a in (xy[:, 0], xy[:, 1], dc))
        vio_c = pcd._violations(x_c, y_c, d_c, *cpu[1:3], *cpu[3:]).numpy()

        def vio_ties():
            world = pcd._img2world(torch.stack([x_c, y_c, torch.ones_like(
                x_c)]), d_c, *cpu[1:3])
            tie = np.zeros(len(d_c), bool)
            for i in range(10):
                xs, ys, dz = pcd._world2img(world, cpu[4][i], cpu[5][i])
                ds, _ = pcd._nearest_sample(cpu[3][i], xs, ys)
                tie |= (near_integer(xs.numpy()) | near_integer(ys.numpy())
                        | (np.abs(ds.numpy() - dz.numpy().astype(np.float64))
                           <= rule.TIE * np.abs(dz.numpy())))
            return tie
        lines += [tie_check("pcd violations (every 8th candidate)",
                            vio.cpu().numpy()[sub], vio_c, vio_ties)]
        require(ok.any().item() and int(vio.sum()) > 0,
                "pcd: no valid candidate or no violation")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    print(f"fusion card vs CPU (reference view 0 of {h}x{w}, 10 sources, "
          f"TF32 allowed; entries that differ / entries): "
          + ", ".join(lines) + "; seconds card / CPU: "
          + ", ".join(f"{k} {a:.3f}" + (f" / {b:.2f}" if b else "")
                      for k, (a, b) in secs.items()) + f"; {smi}",
          flush=True)


def fusion_phase(smi: str) -> None:
    """``mdfnet_tpu_torch.cli.fuse -m filter|vote|pcd`` on the card over an
    11-view synthetic DTU scan at 1600x1184 with GT depths (a tilted plane,
    unit confidence): each cloud non-empty and on the true surface
    (FUSION_SURFACE), seconds per view and pcd's split (its native
    election's share); then the per-view functions on the card against the
    CPU (fusion_device_check)."""
    from mdfnet_tpu_torch.cli.fuse import main as fuse_main
    from mdfnet_tpu_torch.data import write_dtu_eval_tree
    from mdfnet_tpu_torch.fusion.ply import read_ply

    work = smoke_dir("smoke_fusion")
    try:
        scene = write_dtu_eval_tree(
            os.path.join(work, "dtu1600x1200"), scans=(9,),
            nviews=FUSION_VIEWS, height=HEIGHT, width=WIDTH,
            plane_depth=FUSION_PLANE[0], tilt=FUSION_PLANE[1], baseline=12.0)
        write_gt_outputs(os.path.join(work, "outputs"), scene)
        pixels = FUSION_VIEWS * HEIGHT * WIDTH
        for method in ("filter", "vote", "pcd"):
            res = fuse_main(["-m", method, "-d", "dtu", "--root", work,
                             "--scans", "9", "-e",
                             os.path.join(work, "outputs"), "-o",
                             os.path.join(work, f"plys_{method}")])[0]
            xyz, _ = read_ply(res["ply"])
            # world z of the plane: plane_depth + tilt * x (camera 0's
            # frame is the world's)
            resid = np.abs(xyz[:, 2].astype(np.float64) - FUSION_PLANE[0]
                           - FUSION_PLANE[1] * xyz[:, 0])
            med, p99 = np.median(resid), np.percentile(resid, 99)
            times = res["times"]
            split = (", ".join(f"{k} {v:.2f} s" for k, v in times.items())
                     + f"; the native election {times['election']:.2f} s = "
                     f"{times['election'] / res['seconds']:.1%} of the scan"
                     if times else "no native part")
            print(f"fusion {method}: cli.fuse on the card, {FUSION_VIEWS} "
                  f"views {WIDTH}x{HEIGHT}: {len(xyz)} points "
                  f"({len(xyz) / pixels:.1%} of the pixels) in "
                  f"{res['seconds']:.2f} s "
                  f"({res['seconds'] / FUSION_VIEWS:.3f} s/view, host I/O "
                  f"included; {split}); plane residual "
                  f"median {med:.2e} p99 {p99:.2e} (bounds "
                  f"{FUSION_SURFACE[0]:.0e}, {FUSION_SURFACE[1]:.2f}); "
                  f"{smi}", flush=True)
            require(len(xyz) >= FUSION_MIN_SHARE * pixels,
                    f"fusion {method}: {len(xyz)} points")
            require(med <= FUSION_SURFACE[0] and p99 <= FUSION_SURFACE[1],
                    f"fusion {method}: the cloud is off the GT surface")
        fusion_device_check(scene, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def metric_phase(smi: str) -> None:
    """``mdfnet_tpu_torch.cli.dtu_eval`` (host code: numpy, a scipy
    KD-tree) on the cloud that ``cli.fuse -m vote`` fuses on the card from
    a smaller scan, METRIC_SIZE, 11 views of the plane with GT depths,
    against a SampleSet made from the GT surface (view 0 back-projected):
    Acc, Comp and Overall."""
    from scipy.io import savemat
    from mdfnet_tpu_torch.cli.dtu_eval import main as metric_main
    from mdfnet_tpu_torch.cli.fuse import main as fuse_main
    from mdfnet_tpu_torch.data import write_dtu_eval_tree
    from mdfnet_tpu_torch.fusion.ply import write_ply

    work = smoke_dir("smoke_metric")
    try:
        h, w = METRIC_SIZE
        scene = write_dtu_eval_tree(
            os.path.join(work, "dtu1600x1200"), scans=(9,),
            nviews=FUSION_VIEWS, height=h, width=w,
            plane_depth=FUSION_PLANE[0], tilt=FUSION_PLANE[1], baseline=3.0)
        write_gt_outputs(os.path.join(work, "outputs"), scene)
        res = fuse_main(["-m", "vote", "-d", "dtu", "--root", work,
                         "--scans", "9", "-e", os.path.join(work, "outputs"),
                         "-o", os.path.join(work, "plys")])[0]
        k = scene.intrinsics[0].astype(np.float64)
        ys, xs = np.mgrid[0:h, 0:w]
        cam = np.linalg.inv(k) @ np.stack([xs.ravel(), ys.ravel(),
                                           np.ones(h * w)])
        stl = (cam * scene.depths[0].ravel()).T   # camera 0's frame: world
        sample = os.path.join(work, "SampleSet")
        os.makedirs(os.path.join(sample, "Points", "stl"))
        os.makedirs(os.path.join(sample, "ObsMask"))
        write_ply(os.path.join(sample, "Points", "stl", "stl009_total.ply"),
                  stl.astype(np.float32))
        lo, hi, vox = stl.min(0) - 5.0, stl.max(0) + 5.0, 2.0
        mask = np.zeros(tuple(int(np.ceil((hi[i] - lo[i]) / vox)) + 2
                              for i in range(3)), np.uint8)
        q = np.round((stl - lo) / vox).astype(int) + 1
        mask[q[:, 0], q[:, 1], q[:, 2]] = 1
        savemat(os.path.join(sample, "ObsMask", "ObsMask9_10.mat"),
                {"ObsMask": mask, "BB": np.stack([lo, hi]),
                 "Res": np.array([[vox]])})
        savemat(os.path.join(sample, "ObsMask", "Plane9.mat"),
                {"P": np.array([0.0, 0.0, 1.0, -(stl[:, 2].min() - 5.0)])
                 .reshape(4, 1)})
        t0 = time.perf_counter()
        result = metric_main(["--ply_dir", os.path.dirname(res["ply"]),
                              "--sample_set", sample, "--scans", "9"])
        metric_s = time.perf_counter() - t0
        print(f"metric: cli.dtu_eval on scan 9 ({w}x{h}, {FUSION_VIEWS} "
              f"views, vote on the card: {res['points']} points in "
              f"{res['seconds']:.2f} s; stl {len(stl)} points): acc "
              f"{result['acc']:.4f} comp {result['comp']:.4f} overall "
              f"{result['overall']:.4f} in {metric_s:.1f} s on the host "
              f"(bound {METRIC_BOUND}: the pixel footprint "
              f"{FUSION_PLANE[0] / 320:.2f}); {smi}", flush=True)
        require(all(np.isfinite(result[k]) and result[k] <= METRIC_BOUND
                    for k in ("acc", "comp", "overall")),
                f"metric: {result}")
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
    DTU train shapes; a case with a meta is timed: the first of each name
    (bf16) at its main-path shape, K7 and K9 at each of the three stages in
    bf16 and f32. The meta gives the bytes its timed work moves, its operations
    and the PyTorch call timed beside it (None where there is none). K8 results are (output, d_input, d_weight): the kernel Function
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
    cases = []
    # K6 — stage 0 (48 uniform planes, 1/8 res, G = 32) and stage 2 (8
    # per-pixel planes, 1/2 res, G = 8), all 4 sources of 4 items
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
        # grid_sample's normalised grid for the same samples (align_corners
        # False): x_pixel = ((gx + 1) W - 1) / 2
        grid = torch.stack([(2.0 * x + 1.0) / w - 1.0,
                            (2.0 * y + 1.0) / h - 1.0], -1)
        grid = grid.reshape(b * s, d, h * w, 2)
        for dt in (torch.bfloat16, torch.float32):
            img = rnd(b * s, h, w, g).to(dt)
            sample = (lambda p, img=img, x=x, y=y: sample_2d(img, x, y, plain=p))
            n_samples = x.numel()
            sample_meta = dict(
                device=lambda f=sample: f(False),
                nbytes=size(img, x, y) + n_samples * g * img.element_size(),
                ops=n_samples * (10 + 9 * g),
                library=lambda img=cl(img), gd=grid.to(dt): F.grid_sample(
                    img, gd, mode="bilinear", padding_mode="zeros",
                    align_corners=False))
            cases.append(("sample_2d", dt, sample,
                          lambda p, f=sample: cuda_ms(lambda: f(p)),
                          sample_meta if not cases else None))
    # K7 — the three stages (k7_inputs), each timed in bf16 (the dense
    # step's) and f32 (the fused step's), and the stress cameras at stage 0
    for stress in (False, True):
        for stage, dt, (gr, x, y, h, w) in k7_inputs(batch, stress):
            splat = (lambda p, a=(gr, x, y, h, w): splat_2d(*a, plain=p))
            n, d, g = gr.shape[0], gr.shape[1], gr.shape[-1]
            grid = torch.stack([(2.0 * x + 1.0) / w - 1.0,
                                (2.0 * y + 1.0) / h - 1.0], -1)
            splat_meta = dict(
                stage=stage, device=lambda f=splat: f(False),
                nbytes=size(gr, x, y) + n * h * w * g * 4,
                ops=x.numel() * (10 + 8 * g),
                library=lambda gn=gr.reshape(n, d, h * w, g).permute(
                    0, 3, 1, 2), img=torch.zeros(n, g, h, w, dtype=dt,
                                                 device=DEV),
                gd=grid.reshape(n, d, h * w, 2).to(dt):
                torch.ops.aten.grid_sampler_2d_backward(
                    gn, img, gd, 0, 0, False, [True, False]))
            cases.append(("splat_2d" if not stress else "splat_2d stress",
                          dt, splat, lambda p, f=splat: cuda_ms(lambda: f(p)),
                          None if stress else splat_meta))

    # K6 and K7 at C/G != 2 (GROUPS_KERNELS): one source's C = 2 G channels
    # of 4 items a launch, stage 0 (48 uniform planes, C = 64) and stage 2
    # (8 per-pixel planes, C = 16), bf16 then f32; stage 0 in bf16 timed
    gen_groups = torch.Generator(device=DEV).manual_seed(12)
    for stage, d, g, h, w, src_projs, ref_proj, hyp in train_sweeps(
            batch, gen_groups):
        if stage == 1:
            continue
        c = 2 * g
        x, y = sweep_sample_coords(src_projs[:, :1], ref_proj, hyp, h, w)
        grid = torch.stack([(2.0 * x + 1.0) / w - 1.0,
                            (2.0 * y + 1.0) / h - 1.0], -1).reshape(
                                b, d, h * w, 2)
        for dt in (torch.bfloat16, torch.float32):
            img = torch.randn(b, h, w, c, generator=gen_groups,
                              device=DEV).to(dt)
            gr = torch.randn(b, d, h, w, c, generator=gen_groups,
                             device=DEV).to(dt)
            first = stage == 0 and dt == torch.bfloat16
            sample = (lambda p, img=img, x=x, y=y: sample_2d(img, x, y,
                                                             plain=p))
            cases.append(("sample_2d_groups", dt, sample,
                          lambda p, f=sample: cuda_ms(lambda: f(p)),
                          dict(device=lambda f=sample: f(False),
                               nbytes=size(img, x, y) + x.numel() * c
                               * img.element_size(),
                               ops=x.numel() * (10 + 9 * c),
                               library=lambda img=cl(img), gd=grid.to(dt):
                               F.grid_sample(img, gd, mode="bilinear",
                                             padding_mode="zeros",
                                             align_corners=False))
                          if first else None))
            splat = (lambda p, a=(gr, x, y, h, w): splat_2d(*a, plain=p))
            cases.append(("splat_2d_groups", dt, splat,
                          lambda p, f=splat: cuda_ms(lambda: f(p)),
                          dict(device=lambda f=splat: f(False),
                               nbytes=size(gr, x, y) + b * h * w * c * 4,
                               ops=x.numel() * (10 + 8 * c),
                               library=lambda gn=gr.reshape(
                                   b, d, h * w, c).permute(0, 3, 1, 2),
                               im=torch.zeros(b, c, h, w, dtype=dt,
                                              device=DEV), gd=grid.to(dt):
                               torch.ops.aten.grid_sampler_2d_backward(
                                   gn, im, gd, 0, 0, False, [True, False]))
                          if first else None))
        del img, gr

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

            def dgrad(p, x=x, wt=wt, gout=gout, fns=fns):
                """The input gradient alone, from a recorded forward."""
                xg = x.detach().requires_grad_(True)
                y = fns[p](xg, wt)
                g = gout.to(y.dtype)
                return lambda: torch.autograd.grad(y, xg, g, retain_graph=True)

            def backward_ms(p, dgrad=dgrad):
                return cuda_ms(dgrad(p), iters=20)
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
                    device=dgrad(False),
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
    # BN affine at the three stages (k9_inputs), each timed in bf16 and f32,
    # and on the stress cameras at stage 0
    for stress in (False, True):
        for stage, dt, args, bn in k9_inputs(batch, stress):
            src, ref, _, _, hyp, k0 = args
            (h, w, g), d = src.shape[2:], hyp.shape[1]
            points = b * d * h * w
            stats = (lambda p, a=args: rowsweep_stats(*a, plain=p))
            wsum = (lambda p, a=args, bn=bn:
                    rowsweep_aggregate_with_wsum(*a, *bn, plain=p))
            tag = " stress" if stress else ""
            cases += [
                ("rowsweep_stats" + tag, dt, stats,
                 lambda p, f=stats: cuda_ms(lambda: f(p)),
                 None if stress else dict(
                     stage=stage, kernel="rowsweep_stats",
                     nbytes=size(src, ref, hyp, k0),
                     library=None, device=lambda f=stats: f(False),
                     ops=aggregate_ops(points, s, g, True),
                     mufu=stats_mufu(b * h * w, points, s, g))),
                ("rowsweep_aggregate_with_wsum" + tag, dt, wsum,
                 lambda p, f=wsum: cuda_ms(lambda: f(p)),
                 None if stress else dict(
                     stage=stage, kernel="rowsweep_aggregate_kernel",
                     nbytes=size(src, ref, hyp, k0) + points * (g + 1) * 4,
                     library=None, device=lambda f=wsum: f(False),
                     ops=aggregate_ops(points, s, g, False),
                     mufu=aggregate_mufu(b * h * w, points, s, g)))]
    return cases


def check_train_kernels(batch):
    gen = torch.Generator().manual_seed(1)
    report = {}
    for name, dt, run, timer, meta in train_kernel_cases(gen, batch):
        key = name.split()[0]       # "splat_2d stress" reports as splat_2d
        got, ref = run(False), run(True)
        torch.cuda.synchronize()
        err, rel = _rel_err(got, ref)
        entry = report.setdefault(key, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        shape = tuple((got[0] if isinstance(got, tuple) else got).shape)
        line = (f"train kernel {name} {str(dt)[6:]} {shape}: max_abs_err "
                f"{err:.3e} rel {rel:.3e} (tol {REL_TOL[dt]:.0e})")
        if key in ("splat_2d", "splat_2d_groups", "rowsweep_stats"):
            again = run(False)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"{name}: two launches on the same inputs differ")
            line += "; two launches bit-identical"
        if meta is not None:
            # wall per call of back-to-back calls, mostly the host's time
            case = {"shape": list(shape), "dtype": str(dt)[6:]}
            case.update(interleaved_ms({"ms": lambda: timer(False),
                                        "plain_ms": lambda: timer(True)}))
            case.update(bound(key, meta["nbytes"], meta["ops"],
                              meta.get("mufu", 0)))
            case["library_ms"] = (cuda_ms(meta["library"])
                                  if meta["library"] else None)
            # device time: every kernel of one call in a profile
            case["device_ms"] = kernel_device_ms(meta["device"], "")
            case["library_device_ms"] = (
                kernel_device_ms(meta["library"], "") if meta["library"]
                else None)
            line += (f"; {case['ms']:.3f} ms vs plain "
                     f"{case['plain_ms']:.3f} ms, bound "
                     f"{case['bound_ms']:.3f} ms ({case['bound_by']}), "
                     f"library {case['library_ms']} ms; device time "
                     f"{case['device_ms']:.3f} ms, library "
                     f"{case['library_device_ms']} ms")
            if "stage" in meta:
                case["stage"] = meta["stage"]
                case["split"] = device_split(meta["device"])
            if "kernel" in meta:
                # the wrapper's own launches, without its PyTorch set-up
                case["kernel_ms"] = sum(v for k, v in case["split"].items()
                                        if k.startswith(meta["kernel"]))
                line += " (" + ", ".join(f"{k} {v:.4f}" for k, v in
                                         case["split"].items()) + ")"
            if name.endswith("_train"):
                line += " (input gradient)"
            if "ms" not in entry:
                entry.update({k: v for k, v in case.items()
                              if k not in ("shape", "dtype", "stage",
                                           "split", "kernel_ms")})
            entry.setdefault("cases", []).append(case)
        print(line, flush=True)
        require(rel <= REL_TOL[dt] and np.isfinite(err),
                f"{name} disagrees with its plain version")
        del got, ref
    for entry in report.values():
        if len(entry.get("cases", ())) == 1:
            del entry["cases"]
    k7 = report["splat_2d"]["cases"]
    print("train kernel splat_2d per step (3 launches, device ms): "
          + "; ".join(f"{dt} " + " + ".join(
              f"{c['device_ms']:.3f}" for c in k7 if c["dtype"] == dt)
              + f" = {sum(c['device_ms'] for c in k7 if c['dtype'] == dt):.3f}"
              + " (library " + " + ".join(
                  f"{c['library_device_ms']:.3f}" for c in k7
                  if c["dtype"] == dt) + ")"
              for dt in ("bfloat16", "float32")), flush=True)
    stats, k1 = (report[n]["cases"] for n in
                 ("rowsweep_stats", "rowsweep_aggregate_with_wsum"))
    print("train kernel K9 (device ms; the stats kernel's two launches / K1's "
          "train launch, each with its share of its MUFU bound): " + "; ".join(
              f"stage {a['stage']} {a['dtype']} {a['kernel_ms']:.3f} "
              f"({a['mufu_bound_ms'] / a['kernel_ms']:.0%}) / "
              f"{k['kernel_ms']:.3f} "
              f"({k['mufu_bound_ms'] / k['kernel_ms']:.0%})"
              for a, k in zip(stats, k1)), flush=True)
    return report


def _step(dtype: str, plain: bool, batch, *, launches=None,
          warp_impl: str = "dense", config=None):
    """One train step's loss, gradients and per-stage volumes from the
    seed-0 weights, convs in ``dtype`` ("bfloat16" or "float32").
    ``launches``: the counters to zero before the step and read after it
    (the main path's run); ``warp_impl="fused"``: the fused train
    aggregate; ``config``: a ModelConfig in place of the default one with
    that ``warp_impl``."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.train_lib import loss_and_grads
    model = build_model(config or ModelConfig(warp_impl=warp_impl),
                        compute_dtype=dtype, seed=0,
                        device=DEV).requires_grad_(True)
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


def _shifted_splat_taps():
    """A K7 fault: its launches splat each tap one pixel to the right."""
    from mdfnet_tpu_torch.ops import aggregate_train, warp
    from mdfnet_tpu_torch.ops.cuda.splat_kernel import splat_2d

    def faulty(g, x, y, height, width, *, plain=False):
        return splat_2d(g, x if plain else x + 1.0, y, height, width,
                        plain=plain)
    return [(warp, "splat_2d", faulty), (aggregate_train, "splat_2d", faulty)]


# The step gates' injected faults: name -> the patches that inject it.
K6_FAULT = "K6 1-px shift"
K7_FAULT = "K7 1-px shift"
# (path, fault) pairs that the bf16 gate cannot see: the fused step runs K6
# only in its backward, and both steps run K7 only there, where every bf16
# metric reads the fault as it reads a correct order (PERF.md section 2).
# The f32 gate holds each of them (and fused_gate the fused step's).
BF16_BLIND = {("fused", K6_FAULT), ("dense", K7_FAULT), ("fused", K7_FAULT)}
FAULTS = {
    "conv3d tap": lambda: _zeroed_corner_tap(
        lambda kd, k, co, tr: kd == 3 and not tr and co > 1),
    "trconv3d tap": lambda: _zeroed_corner_tap(lambda kd, k, co, tr: tr),
    "conv2d 3x3 tap": lambda: _zeroed_corner_tap(
        lambda kd, k, co, tr: kd == 1 and k == 3),
    "ProbConv tap": lambda: _zeroed_corner_tap(
        lambda kd, k, co, tr: kd == 3 and not tr and co == 1),
    K6_FAULT: _shifted_sample_taps,
    K7_FAULT: _shifted_splat_taps,
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
    return ", ".join(f"{k} {v:.2e}" for k, v in metrics.items()
                     if not isinstance(v, str))


def train_gate(batch, warp_impl: str = "dense"):
    """The bf16 and f32 step gates; returns the bf16 step's launches, its
    tc-route launches per conv counter, and the f32 kernel step's (loss,
    gradients). The f32 step must take the direct kernels only. Each of
    FAULTS but those of BF16_BLIND, injected into the bf16 step, must read
    at least twice its bound on one of the bf16 gate's metrics; each,
    injected into the f32 step, on one of the f32 gate's."""
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
        require(over[worst] >= 2.0 or (warp_impl, name) in BF16_BLIND,
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
    m32 = f32_gate_metrics(loss_k, f32_param_stats(grads_k, grads_p), loss_p)
    print(f"{warp_impl} train gate f32 kernels vs plain f32 ({len(grads_p)} "
          f"parameters): " + ", ".join(
              f"{k} {m32[k]:.2e}" + (f" (bound {STEP_BOUNDS_F32[k]:.1e})"
                                     if k in STEP_BOUNDS_F32 else "")
              for k in m32 if k not in ("worst", "raw worst"))
          + f"; worst {m32['worst']}, raw worst {m32['raw worst']}",
          flush=True)
    for k, b in STEP_BOUNDS_F32.items():
        require(m32[k] <= b, f"train gate f32: {k} {m32[k]:.2e} > {b:.1e} "
                f"({m32['worst']})")
    caught = []
    for name, patches in FAULTS.items():
        with patched(patches()):
            loss_x, grads_x, _, _ = _step("float32", False, batch,
                                          warp_impl=warp_impl)
        m = f32_gate_metrics(loss_x, f32_param_stats(grads_x, grads_p),
                             loss_p)
        del grads_x
        over = {k: m[k] / b for k, b in STEP_BOUNDS_F32.items()}
        worst = max(over, key=over.get)
        caught.append(f"{name}: {worst} {over[worst]:.1f}x")
        require(over[worst] >= 2.0, f"train gate f32: the injected fault "
                f"'{name}' reads within 2x of every bound ({_show(m)})")
    print(f"{warp_impl} train gate f32, injected faults (the metric most "
          f"over its bound): " + "; ".join(caught), flush=True)
    return launches, tc, (loss_k, grads_k)


# ------------------------------------------------- the step gates' spread

# Equally correct summation orders of the step, read in this tree: name ->
# the conv route rule it runs under, made from the tree's own rule (the f32
# step takes no tc route, so "K3 direct" is "tree" there and "all direct"
# moves its Co = 1 convs off the co1 kernel)
ORDERS = {
    "tree": lambda rule: rule,
    "tree again": lambda rule: rule,
    "K3 direct": lambda rule: lambda dt, kd, k, s, ci, co, tr=False: (
        "direct" if tr else rule(dt, kd, k, s, ci, co)),
    "all direct": lambda rule: lambda *a: "direct",
}
# ... and in copies of this tree, outside it, with sources edited by text
# substitution ([(file, [(old, new), ...]), ...]): the tc kernels flushing
# their tensor-core sums every N K steps (csrc/wgmma.cuh kFlush; unflushed:
# one run per GEMM or weight stage); K1 (and with it the stats kernel,
# which shares common.cuh's group_field) summing its group's field by a
# butterfly of shuffles and dividing by one reciprocal of the weight sum;
# the co1 kernel running its channel chunks (16-byte units) outermost
_K1_FIELD = """  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float t = s;
#pragma unroll
    for (int i = 0; i < kCh; ++i) t = fmaf(sim[i], k0[i], t);
    s = L > 1 ? __shfl_sync(0xffffffffu, t, l, L) : t;
  }
  return s;"""
_K1_BUTTERFLY = """  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kCh; ++i) t = fmaf(sim[i], k0[i], t);
#pragma unroll
  for (int m = 1; m < L; m <<= 1) t += __shfl_xor_sync(0xffffffffu, t, m, L);
  return t;"""
_KD_LOOP = """#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {"""
COPIES = {
    **{name: [("wgmma.cuh", [("constexpr int kFlush = 9;",
                               f"constexpr int kFlush = {every};")])]
       for name, every in (("kFlush 3", 3), ("kFlush 27", 27),
                           ("unflushed", 1 << 20))},
    "K1 butterfly": [
        ("common.cuh", [(_K1_FIELD, _K1_BUTTERFLY)]),
        ("rowsweep_aggregate.cu", [("v[i] = acc[i] / wsum;",
                                    "v[i] = acc[i] * (1.0f / wsum);")])],
    "co1 chunks outermost": [("conv_co1.cu", [
        (_KD_LOOP, "#pragma unroll\n    for (int u0 = 0; u0 < NU; ++u0)\n"
         + _KD_LOOP),
        ("for (int u = 0; u < NU; ++u) {",
         "for (int u = u0; u == u0; ++u) {")])],
}


def f32_param_stats(grads, ref) -> dict:
    """Per parameter (f64): [|g - r|, |r|, cosine of g and r]."""
    out = {}
    for n, r in ref.items():
        g, r = grads[n].flatten().double(), r.flatten().double()
        out[n] = [(g - r).norm().item(), r.norm().item(),
                  (g @ r / (g.norm() * r.norm())).item()]
    return out


def f32_gate_metrics(loss, stats, loss_ref) -> dict:
    """The f32 step gate's metrics from a step's loss and f32_param_stats
    against the plain f32 step: the loss's relative error, each parameter's
    gradient error relative to the larger of its own norm and a tenth of
    its layer's (the parameters of one module) as its maximum ("grad rel
    err") and median, the plain relative error's maximum ("raw grad rel
    err", no floor), and 1 - the least cosine."""
    layer = {}
    for n, (_, rn, _) in stats.items():
        key = n.rsplit(".", 1)[0]
        layer[key] = layer.get(key, 0.0) + rn * rn
    floored = {n: d / max(rn, F32_LAYER_SHARE * math.sqrt(
        layer[n.rsplit(".", 1)[0]]), 1e-30) for n, (d, rn, _) in stats.items()}
    raw = {n: d / max(rn, 1e-30) for n, (d, rn, _) in stats.items()}
    worst = max(floored, key=floored.get)
    return {"loss": abs(loss - loss_ref) / abs(loss_ref),
            "grad rel err": floored[worst],
            "median grad rel err": float(np.median(list(floored.values()))),
            "raw grad rel err": max(raw.values()),
            "1 - min cos": 1.0 - min(c for _, _, c in stats.values()),
            "worst": worst, "raw worst": max(raw, key=raw.get)}


def gate_readings(names) -> dict:
    """The bf16 gate's metrics (bf16_gate_metrics) and the f32 gate's
    (f32_gate_metrics, with the per-parameter f32_param_stats) of the dense
    and the fused step under each of ``names`` (ORDERS or FAULTS), each
    against the plain f32 step of its path."""
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
                bf16 = bf16_gate_metrics((loss, grads, vols),
                                         (loss_p, grads_p, vols_p))
                del grads, vols
                loss, grads, _, _ = _step("float32", False, batch,
                                          warp_impl=impl)
            stats = f32_param_stats(grads, grads_p)
            out.setdefault(name, {})[impl] = {
                "bf16": bf16, "f32": f32_gate_metrics(loss, stats, loss_p),
                "f32 params": stats}
            del grads
        del grads_p, vols_p
    return out


def edited_copy(tmp: str, name: str, sources) -> str:
    """A copy of the port and this script under ``tmp`` in which, for each
    (source, edits) of ``sources``, the kernel source (csrc/) has each (old,
    new) of ``edits`` substituted once; returns its root (its kernels build
    there at first use)."""
    copy = os.path.join(tmp, name.replace(" ", "_").replace(",", ""))
    shutil.copytree(os.path.join(ROOT, "mdfnet_tpu_torch"),
                    os.path.join(copy, "mdfnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
    for source, edits in sources:
        src = os.path.join(copy, _SRC, source)
        with open(src) as f:
            text = f.read()
        for old, new in edits:
            require(text.count(old) == 1, f"{name}: {old!r} is not once in "
                    f"{source}")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
    return copy


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
    """The bf16 and the f32 step gate's metrics over equally correct
    summation orders (ORDERS in this tree; COPIES of it under a temporary
    directory, each built on the card) and over the injected FAULTS; prints
    the tables of both gates, with 2x the worst correct reading of each
    metric, and writes them (with the f32 step's per-parameter statistics)
    to build/gate_spread.json."""
    readings = _readings(ROOT, [*ORDERS, *FAULTS])
    with tempfile.TemporaryDirectory() as tmp:
        for name, sources in COPIES.items():
            copy = edited_copy(tmp, name, sources)
            readings[name] = _readings(copy, ["tree"])["tree"]
    orders = [n for n in readings if n not in FAULTS]
    for gate in ("bf16", "f32"):
        metrics = [m for m, v in readings["tree"]["dense"][gate].items()
                   if not isinstance(v, str)]
        worst = {m: max(readings[o][i][gate][m] for o in orders
                        for i in ("dense", "fused")) for m in metrics}
        for title, names in (("orders", orders), ("faults", list(FAULTS))):
            print(f"gate spread {gate}, {title} (dense / fused): "
                  + "; ".join(f"{n}: " + ", ".join(
                      f"{m} {readings[n]['dense'][gate][m]:.3e} / "
                      f"{readings[n]['fused'][gate][m]:.3e}" for m in metrics)
                      + (f" (worst {readings[n]['dense'][gate]['worst']} / "
                         f"{readings[n]['fused'][gate]['worst']})"
                         if gate == "f32" else "") for n in names),
                  flush=True)
        print(f"gate spread {gate}: 2x the worst correct reading: "
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
    the kernels (FUSED_BOUNDS), and the same with each of three faults
    injected into the fused backward (the BN backward without its mean
    term, K6_FAULT and K7_FAULT, which the bf16 gate cannot see there),
    each of which must read at least twice a bound. Returns the fused bf16
    step's launches."""
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
              K6_FAULT: FAULTS[K6_FAULT](), K7_FAULT: FAULTS[K7_FAULT]()}
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


# ------------------------------------- data parallelism over ranks, remat

# data_parallel_phase: 2 ranks (one card each where there are two, else both
# on one card over gloo) split the DTU train batch, 2 items a rank
DP_WORLD, DP_BF16_STEPS = 2, 5
# every rank is joined within DP_TIMEOUT seconds, and a collective that
# waits longer than DP_COLLECTIVE_TIMEOUT fails: a hung rank fails the run
DP_TIMEOUT, DP_COLLECTIVE_TIMEOUT = 300.0, 120.0
# the averaged running statistics on rank 0 against the one-process
# emulation: the same per-shard forwards on the same kernels, averaged in
# the same order; the CPU tests' bound against JAX
DP_STATS_BOUND = 1e-5
# remat_phase: the bf16 step's peak memory with and without remat at DTU
# train and at BlendedMVS's 768x576 with its batch of 6 (synthetic)
REMAT_SHAPES = ((TRAIN_HEIGHT, TRAIN_WIDTH, TRAIN_BATCH), (576, 768, 6))


def dp_batch():
    """train_batch() with distinct items (item i's images scaled by 0.8 +
    0.1 i), so that each shard's BatchNorm statistics are its own."""
    batch = train_batch()
    scale = 0.8 + 0.1 * torch.arange(TRAIN_BATCH, device=DEV)
    batch["imgs"] = batch["imgs"] * scale.reshape(-1, 1, 1, 1, 1)
    return batch


def state_digest(model, optimizer) -> str:
    """A digest of every parameter, buffer and Adam moment, in order."""
    h = hashlib.sha256()
    tensors = [*model.parameters(), *model.buffers()]
    for state in optimizer.state.values():
        tensors += [state["exp_avg"], state["exp_avg_sq"]]
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _skip_gradient_reduction(model, group):
    """The DP fault: the rank joins the gradient all-reduce (so that the
    collectives pair up) but keeps its own shard's gradients."""
    from mdfnet_tpu_torch import train_lib
    train_lib._all_reduce([p.grad.clone() for p in model.parameters()
                           if p.grad is not None], group)


def _dp_rank(rank, world, backend, init_method, out):
    """One rank of data_parallel_phase (spawn_ranks starts it): one f32
    step, the same step with rank 0 skipping the gradient reduction, then
    DP_BF16_STEPS bf16 steps, each from the seed-0 weights on the rank's
    shard of dp_batch(); writes what it read to <out>/rank<r>.pt."""
    from mdfnet_tpu_torch import train_lib
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.parallel import (init_data_parallel, rank_device,
                                           shard_batch)
    device = rank_device(rank, "cuda")
    group = init_data_parallel(rank, world, backend, init_method,
                               timeout=DP_COLLECTIVE_TIMEOUT)
    try:
        shard = shard_batch(dp_batch(), rank, world)

        def fresh(dtype):
            model = build_model(ModelConfig(), compute_dtype=dtype, seed=0,
                                device=device).requires_grad_(True)
            return model, train_lib.make_optimizer(
                model, train_lib.poly_lr(1, 1e-3, 30, 0.9))

        def grads(model):
            return {n: p.grad.float().cpu()
                    for n, p in model.named_parameters()}
        model, opt = fresh("float32")
        result = {"device": torch.cuda.get_device_name(device),
                  "f32 loss": float(train_lib.train_step(model, opt, shard,
                                                         group=group))}
        result["f32 grads"] = grads(model)
        result["f32 stats"] = {n: b.cpu() for n, b in model.named_buffers()
                               if "running" in n}
        model, opt = fresh("float32")
        reduce = train_lib.reduce_gradients
        if rank == 0:
            train_lib.reduce_gradients = _skip_gradient_reduction
        try:
            train_lib.train_step(model, opt, shard, group=group)
        finally:
            train_lib.reduce_gradients = reduce
        result["fault grads"] = grads(model)
        del model, opt
        model, opt = fresh("bfloat16")
        torch.cuda.reset_peak_memory_stats(device)
        losses, times = [], []
        for _ in range(DP_BF16_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            losses.append(float(train_lib.train_step(model, opt, shard,
                                                     group=group)))
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        result.update(losses=losses, times=times,
                      peak_mb=torch.cuda.max_memory_allocated(device) / 2**20,
                      digest=state_digest(model, opt))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def data_parallel_phase(smi: str) -> None:
    """Data-parallel training (parallel/mesh.py, train_lib.train_step with a
    process group) at DTU train on DP_WORLD spawned ranks: with a card a
    rank over NCCL, else both on one card over gloo (two ranks on one card
    check correctness, not scaling). The f32 gate: rank 0's reduced
    gradients and averaged running statistics after one step against the
    one-process emulation of the same semantics on the card
    (train_lib.data_parallel_reference: each shard's forward and backward
    with its own BatchNorm statistics, the global loss's gradient, the
    statistics averaged) under STEP_BOUNDS_F32 and DP_STATS_BOUND; rank 0
    skipping the gradient reduction must read >= 2x a bound; after
    DP_BF16_STEPS bf16 steps every parameter, buffer and Adam moment must
    have one digest on both ranks; ms/step and peak memory per rank. Then
    the train CLI with --world-size 2."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.parallel import default_backend, spawn_ranks
    from mdfnet_tpu_torch.train_lib import data_parallel_reference
    backend = default_backend(DP_WORLD, "cuda")
    how = (f"NCCL, a card a rank ({torch.cuda.device_count()} cards)"
           if backend == "nccl" else
           "gloo, both ranks on one card: a check of correctness, not a "
           "scaling number")
    out = smoke_dir("smoke_dp")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(_dp_rank, DP_WORLD, (backend, f"file://{out}/pg", out),
                timeout=DP_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))
             for r in range(DP_WORLD)]
    model = build_model(ModelConfig(), compute_dtype="float32", seed=0,
                        device=DEV).requires_grad_(True)
    loss_ref = float(data_parallel_reference(model, dp_batch(), DP_WORLD))
    grads_ref = {n: p.grad.float() for n, p in model.named_parameters()}
    stats_ref = {n: b for n, b in model.named_buffers() if "running" in n}
    del model
    r0 = ranks[0]

    def gate(grads):
        return f32_gate_metrics(r0["f32 loss"], f32_param_stats(
            {n: g.to(DEV) for n, g in grads.items()}, grads_ref), loss_ref)
    clean, fault = gate(r0["f32 grads"]), gate(r0["fault grads"])
    stats_err = max((b.to(DEV) - stats_ref[n]).abs().max().item()
                    for n, b in r0["f32 stats"].items())
    caught = [k for k, b in STEP_BOUNDS_F32.items() if fault[k] >= 2 * b]
    print(f"data parallel, {DP_WORLD} ranks ({how}), DTU train "
          f"{TRAIN_WIDTH}x{TRAIN_HEIGHT}x{NVIEWS} global batch {TRAIN_BATCH} "
          f"(distinct items, {TRAIN_BATCH // DP_WORLD} a rank), ranks on "
          f"{[r['device'] for r in ranks]}: f32 step on rank 0 vs the "
          f"one-process emulation on the card: loss {r0['f32 loss']:.6f} vs "
          f"{loss_ref:.6f}; " + ", ".join(
              f"{k} {clean[k]:.2e} (bound {b:.1e})"
              for k, b in STEP_BOUNDS_F32.items())
          + f"; worst {clean['worst']}; running statistics max |diff| "
          f"{stats_err:.2e} (bound {DP_STATS_BOUND:.0e}); rank 0 skipping "
          f"the gradient reduction: {_show({k: fault[k] for k in STEP_BOUNDS_F32})}"
          f", >= 2x {caught}; {smi}", flush=True)
    print(f"data parallel bf16, {DP_BF16_STEPS} steps a rank ({how}): "
          + "; ".join(f"rank {r}: {statistics.median(v['times'][1:]):.2f} "
                      f"ms/step (runs {[round(t, 1) for t in v['times']]}), "
                      f"peak {v['peak_mb']:.0f} MiB, losses "
                      f"{[round(x, 3) for x in v['losses']]}, digest "
                      f"{v['digest']}" for r, v in enumerate(ranks))
          + f"; spawn to join {ranks_s:.1f} s; {smi}", flush=True)
    for k, b in STEP_BOUNDS_F32.items():
        require(clean[k] <= b, f"data parallel f32 gate: {k} {clean[k]:.2e} "
                f"> {b:.1e} ({clean['worst']})")
    require(stats_err <= DP_STATS_BOUND,
            f"data parallel: running statistics {stats_err:.2e} from the "
            f"emulation's")
    require(bool(caught), "data parallel: a rank skipping the gradient "
            "reduction stays within 2x of every f32 bound")
    require(len({r["digest"] for r in ranks}) == 1,
            "data parallel: the replicas differ after the bf16 steps")
    require(all(math.isfinite(x) for r in ranks for x in r["losses"]),
            "data parallel: a non-finite bf16 loss")
    dp_cli_phase(backend)


def run_session(cmd, timeout: float) -> subprocess.CompletedProcess:
    """Run ``cmd`` in a session of its own from the checkout; past
    ``timeout`` seconds the session (the command and what it started) is
    sent SIGUSR1 (spawned ranks print their stacks), then killed, and this
    raises with the end of its output."""
    proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGUSR1)
        time.sleep(5.0)
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"{' '.join(cmd[1:4])} ran past {timeout} s:\n"
                           + "\n".join(out.strip().splitlines()[-80:]))
    return subprocess.CompletedProcess(cmd, proc.returncode, out, "")


def dp_cli_phase(backend: str) -> None:
    """``python -m mdfnet_tpu_torch.train --fast --world-size 2`` for one
    epoch on a synthetic DTU train tree: rank 0 alone writes one checkpoint
    and one epoch_loss.txt line; the checkpoint loads strict=True."""
    from mdfnet_tpu_torch.data import write_dtu_train_tree
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.utils.weights import load_checkpoint
    work = smoke_dir("smoke_dp_train")
    try:
        write_dtu_train_tree(os.path.join(work, "dtu640x512"), scans=(1,),
                             nviews=7, lightings=1, height=TRAIN_HEIGHT,
                             width=TRAIN_WIDTH)
        out = os.path.join(work, "ckpt")
        t0 = time.perf_counter()
        proc = run_session(
            [sys.executable, "-m", "mdfnet_tpu_torch.train", "-d", "dtu",
             "--root", work, "--scans", "1", "--lightings", "1", "--epochs",
             "1", "--batch-size", str(TRAIN_BATCH), "--fast", "--ckpt-dir",
             out, "--world-size", str(DP_WORLD)], timeout=DP_TIMEOUT)
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0, "train CLI --world-size 2 failed:\n"
                + "\n".join(proc.stdout.strip().splitlines()[-30:]))
        require(sorted(os.listdir(out)) == ["dtu_1.pth", "epoch_loss.txt"],
                f"train CLI --world-size 2 wrote {sorted(os.listdir(out))}")
        with open(os.path.join(out, "epoch_loss.txt")) as f:
            losses = [float(v) for v in f.read().split()]
        require(len(losses) == 1 and math.isfinite(losses[0]),
                f"epoch_loss.txt: {losses}")
        epoch = load_checkpoint(build_model(device=DEV, seed=5),
                                os.path.join(out, "dtu_1.pth"))
        print(f"train CLI --world-size {DP_WORLD} ({backend}): 1 epoch in "
              f"{cli_s:.1f} s, epoch loss {losses[0]:.4f}; rank 0 wrote "
              f"dtu_1.pth (epoch {epoch}, loads strict=True) and one "
              f"epoch_loss.txt line", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _remat_step(dtype: str, remat: bool, batch):
    """One train step (train_lib.train_step) from the seed-0 weights,
    convs in ``dtype``: (loss, gradients, buffers, ms, peak MiB of the
    step after one warm-up step)."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.train_lib import make_optimizer, train_step
    model = build_model(ModelConfig(remat=remat), compute_dtype=dtype,
                        seed=0, device=DEV).requires_grad_(True)
    opt = make_optimizer(model, 1e-3)
    if dtype == "bfloat16":     # warm-up: Adam's state, the allocator
        train_step(model, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(train_step(model, opt, batch))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    return (loss, {n: p.grad.float() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}, ms, peak)


def remat_phase(batch, smi: str) -> None:
    """ModelConfig(remat=True) (models/core.py): one f32 step with remat
    against one without on the kernels under STEP_BOUNDS_F32, the running
    statistics bit-equal (updated once, not again in the recomputation);
    then one bf16 step's ms and peak memory with and without remat at each
    of REMAT_SHAPES."""
    from mdfnet_tpu_torch.data import make_batch, make_plane_scene
    from mdfnet_tpu_torch.train_lib import batch_to_device
    loss_p, grads_p, bufs_p, _, _ = _remat_step("float32", False, batch)
    loss_r, grads_r, bufs_r, _, _ = _remat_step("float32", True, batch)
    m32 = f32_gate_metrics(loss_r, f32_param_stats(grads_r, grads_p), loss_p)
    same = all(torch.equal(bufs_r[n], b) for n, b in bufs_p.items())
    del grads_p, grads_r, bufs_p, bufs_r
    reads = []
    for h, w, b in REMAT_SHAPES:
        scene = make_plane_scene(height=h, width=w, nviews=NVIEWS, tilt=0.05,
                                 focal=1.8 * w)
        big = batch_to_device(make_batch(scene, batch=b), DEV)
        for remat in (False, True):
            torch.cuda.empty_cache()
            _, _, _, ms, peak = _remat_step("bfloat16", remat, big)
            reads.append(f"{w}x{h}x{NVIEWS} batch {b} "
                         f"{'remat' if remat else 'plain'} {peak:.0f} MiB "
                         f"{ms:.1f} ms")
        del big
    print(f"remat: f32 step with remat vs without on the kernels: loss "
          f"{loss_r:.6f} vs {loss_p:.6f}; " + ", ".join(
              f"{k} {m32[k]:.2e} (bound {b:.1e})"
              for k, b in STEP_BOUNDS_F32.items())
          + f"; running statistics bit-equal {same}; bf16 step peak memory "
          f"and time (one step after a warm-up): " + "; ".join(reads)
          + f"; {smi}", flush=True)
    for k, b in STEP_BOUNDS_F32.items():
        require(m32[k] <= b, f"remat vs plain f32 step: {k} {m32[k]:.2e} > "
                f"{b:.1e} ({m32['worst']})")
    require(same, "remat: the running statistics differ from the plain "
            "step's")


# spatial_phase: the eval forward with the image height sharded over each of
# SPATIAL_WORLDS ranks (parallel/spatial.py): on one card the ranks share it
# over gloo (a check of correctness and memory per rank, not a scaling
# number); with a card a rank they talk over NCCL.
# DTU full width with the 1184 crop aligned down to a multiple of 32 x 4
# (cli/eval.py align_crop), the top 1152 rows of the forward phase's scene
SPATIAL_HEIGHT, SPATIAL_WORLDS = 1152, (2, 4)
# the f32 kernels sharded against the f32 kernels unsharded: JAX
# test_spatial.py's bounds (depth max over the depth range, confidence max)
SPATIAL_BOUNDS = {"depth max": 1e-5, "confidence max": 1e-4}
SPATIAL_TIMEOUT, SPATIAL_MAPS = 300.0, 4
# the C/G != 2 unit that JAX's tests shard (K6 at stage 0 and beyond)
SPATIAL_GROUPS = dict(ngroups=(16, 8, 4))


def spatial_args(scene):
    from mdfnet_tpu_torch.data import make_batch
    batch = make_batch(scene, batch=1)
    batch["imgs"] = np.ascontiguousarray(batch["imgs"][:, :, :SPATIAL_HEIGHT])
    return [torch.from_numpy(batch[k]).to(DEV)
            for k in ("imgs", "extrinsics", "intrinsics", "depth_range")]


def spatial_models(device, **fields):
    """(f32 model, bf16 model) with the forward gate's sharpened seed-0
    weights (sharpen), on ``device``."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    f32 = build_model(ModelConfig(**fields), seed=0, device=device)
    sharpen(f32)
    bf16 = build_model(ModelConfig(compute_dtype="bfloat16", **fields),
                       seed=0, device=device)
    bf16.load_state_dict(f32.state_dict())
    return f32, bf16


def _zero_halo_rows():
    """The injected fault: every halo exchange delivers zero rows in place
    of the neighbours' (the collectives still pair up; the all-gathers of
    the sources are left as they are); returns the undo."""
    from mdfnet_tpu_torch.parallel import halo
    rows = halo._neighbour_rows

    def zeroed(x, h_axis, lo, hi):
        return tuple(None if t is None else torch.zeros_like(t)
                     for t in rows(x, h_axis, lo, hi))
    halo._neighbour_rows = zeroed
    return lambda: setattr(halo, "_neighbour_rows", rows)


def _spatial_rank(rank, world, backend, init_method, out):
    """One rank of spatial_phase: the f32 and bf16 sharded forwards (the
    bf16 one timed, its launches and exchanges counted, its peak memory
    read), the f32 one with a zeroed halo, and at world 2 the C/G != 2
    config's f32 forward, on the inputs in <out>/args.pt; rank 0 keeps the
    gathered maps."""
    from mdfnet_tpu_torch.parallel import (halo, init_data_parallel,
                                           rank_device, spatial_eval_forward)
    device = rank_device(rank, "cuda")
    group = init_data_parallel(rank, world, backend, init_method,
                               timeout=DP_COLLECTIVE_TIMEOUT)
    try:
        # on the host: each rank moves its band of the images alone
        args = torch.load(os.path.join(out, "args.pt"))
        f32, bf16 = spatial_models(device)

        def fwd(model):
            got = spatial_eval_forward(model, *args, group)
            return {k: got[k].float().cpu() for k in ("depth", "confidence")}
        result = {"f32": fwd(f32)}
        fwd(bf16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held_mb = torch.cuda.memory_allocated(device) / 2**20
        reset_launches()
        halo.EXCHANGES.update(calls=0, bytes=0)
        times = []
        for _ in range(SPATIAL_MAPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result["bf16"] = fwd(bf16)
            times.append((time.perf_counter() - t0) * 1e3)
        from mdfnet_tpu_torch.ops.cuda import aggregate_kernel, conv_kernel
        result.update(
            times=times, held_mb=held_mb,
            peak_mb=torch.cuda.max_memory_allocated(device) / 2**20,
            launches={k: v // SPATIAL_MAPS for c in (
                aggregate_kernel.LAUNCHES, conv_kernel.LAUNCHES)
                for k, v in c.items() if k in KERNELS},
            exchanges={k: v // SPATIAL_MAPS
                       for k, v in halo.EXCHANGES.items()})
        undo = _zero_halo_rows()
        try:
            result["fault"] = fwd(f32)
        finally:
            undo()
        if world == 2:
            from mdfnet_tpu_torch.ops.cuda import warp_kernel
            g32, _ = spatial_models(device, **SPATIAL_GROUPS)
            reset_launches()
            result["groups"] = fwd(g32)
            result["groups k6"] = warp_kernel.LAUNCHES["sample_2d"]
        torch.save(result if rank == 0 else {
            k: result[k] for k in ("times", "held_mb", "peak_mb", "launches",
                                   "exchanges")},
            os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _map_errors(got: dict, ref: dict) -> dict:
    depth = ((got["depth"] - ref["depth"]).abs()
             / (DEPTH_RANGE[1] - DEPTH_RANGE[0])).flatten().numpy()
    conf = (got["confidence"] - ref["confidence"]).abs()
    return {"depth max": float(depth.max()),
            "depth median": float(np.median(depth)),
            "depth p95": float(np.percentile(depth, 95)),
            "confidence max": conf.max().item(),
            "confidence mean |diff|": conf.mean().item()}


def k1_band_case(scene) -> dict:
    """K1 at stage 0 of the 1152-row forward: a rank's band launch (rows
    of SPATIAL_WORLDS' bands, row0 into the full-height sources) against
    its plain version and beside the full launch, by wall (CUDA events
    around the wrapper) and by the kernel's own device time."""
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel
    gen = torch.Generator().manual_seed(15)
    src, ref, src_projs, ref_proj, hyp, k0, *sc = k1_inputs(
        gen, scene, torch.bfloat16, height=SPATIAL_HEIGHT)[0]
    b, s, hs, w, g = src.shape
    d = hyp.shape[1]

    def launch(rows, row0, plain=False):
        band = ref[:, rows].contiguous()
        return lambda: aggregate_kernel.rowsweep_aggregate(
            src, band, src_projs, ref_proj, hyp, k0, *sc, row0=row0,
            plain=plain)
    kernel = "rowsweep_aggregate_kernel"
    out = {"full_ms": cuda_ms(launch(slice(0, hs), 0)),
           "full_device_ms": kernel_device_ms(launch(slice(0, hs), 0),
                                              kernel), "bands": {}}
    for n in SPATIAL_WORLDS:
        h = hs // n
        rows = slice(h, 2 * h)             # rank 1's band
        got, want = launch(rows, h)(), launch(rows, h, plain=True)()
        err, rel = _rel_err(got, want)
        require(rel <= REL_TOL[torch.bfloat16],
                f"K1 band launch n={n}: {rel:.2e} of the plain version")
        full = launch(slice(0, hs), 0)()
        same = torch.equal(got, full[:, :, rows])
        points = b * d * h * w
        out["bands"][n] = dict(
            shape=f"{h}/{hs}x{w}x{g} D{d} S{s}", max_abs_err=err,
            ms=cuda_ms(launch(rows, h)),
            device_ms=kernel_device_ms(launch(rows, h), kernel),
            plain_ms=cuda_ms(launch(rows, h, plain=True), iters=3),
            equals_full_rows=same, **bound(
                "rowsweep_aggregate", size(src, ref[:, rows], hyp)
                + points * g * 4, aggregate_ops(points, s, g, False),
                aggregate_mufu(b * h * w, points, s, g)))
        require(same, f"K1 band launch n={n}: not the full launch's rows")
    return out


def spatial_phase(smi: str) -> dict:
    """The eval forward at DTU full width, 1600x1152 x 5 views, with H
    sharded over 2 and 4 ranks (sharing the card over gloo, or a card a
    rank over NCCL): f32 kernels
    sharded vs unsharded (SPATIAL_BOUNDS), bf16 sharded vs the plain f32
    unsharded forward (the forward gate's depth and confidence bounds) and
    its share of pixels whose bits differ from the bf16 unsharded forward,
    a zeroed halo (>= 2x a bound), every kernel of the path launched on
    every rank, peak memory and ms/map per rank beside the unsharded; the
    C/G != 2 config on K6 at n = 2; K1's band launch; the eval CLI with
    --spatial 2. Returns K1's band case for the kernel line."""
    from mdfnet_tpu_torch.parallel import default_backend, spawn_ranks
    scene = dtu_scene()
    args = spatial_args(scene)
    f32, bf16 = spatial_models(DEV)
    plain = {k: v.float().cpu() for k, v in f32(*args, plain=True).items()
             if k != "coverage_ok"}
    ref32 = {k: v.float().cpu() for k, v in f32(*args).items()
             if k != "coverage_ok"}
    bf16(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mb = torch.cuda.memory_allocated() / 2**20
    times = []
    for _ in range(SPATIAL_MAPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bf16(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ref16 = {k: out[k].float().cpu() for k in ("depth", "confidence")}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    g32, _ = spatial_models(DEV, **SPATIAL_GROUPS)
    ref_groups = {k: v.float().cpu() for k, v in g32(*args).items()
                  if k != "coverage_ok"}
    del f32, bf16, g32, out
    torch.cuda.empty_cache()
    print(f"spatial: unsharded {WIDTH}x{SPATIAL_HEIGHT}x{NVIEWS} bf16 "
          f"{statistics.median(times[1:]):.2f} ms/map, peak {peak_mb:.0f} "
          f"MiB ({held_mb:.0f} of it held before the forwards); {smi}",
          flush=True)
    failures = []
    for n in SPATIAL_WORLDS:
        out_dir = smoke_dir(f"smoke_spatial{n}")
        torch.save([a.cpu() for a in args], os.path.join(out_dir, "args.pt"))
        t0 = time.perf_counter()
        backend = default_backend(n, "cuda")
        how = ("NCCL, a card a rank" if backend == "nccl" else
               f"gloo, {n} ranks share one card: not a scaling number")
        spawn_ranks(_spatial_rank, n, (backend, f"file://{out_dir}/pg",
                                       out_dir),
                    timeout=SPATIAL_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
                 for r in range(n)]
        r0 = ranks[0]
        e32 = _map_errors(r0["f32"], ref32)
        e16 = _map_errors(r0["bf16"], plain)
        ef = _map_errors(r0["fault"], ref32)
        bits = (r0["bf16"]["depth"] != ref16["depth"]).float().mean().item()
        cbits = (r0["bf16"]["confidence"]
                 != ref16["confidence"]).float().mean().item()
        caught = [k for k, b in SPATIAL_BOUNDS.items() if ef[k] >= 2 * b]
        line = (f"spatial n={n} ({how}), {WIDTH}x{SPATIAL_HEIGHT}x{NVIEWS}: "
                f"f32 "
                f"kernels sharded vs unsharded: " + ", ".join(
                    f"{k} {e32[k]:.2e} (bound {b:.0e})"
                    for k, b in SPATIAL_BOUNDS.items())
                + f"; bf16 sharded vs plain f32 unsharded: depth median "
                f"{e16['depth median']:.2e} p95 {e16['depth p95']:.2e} "
                f"(bounds {MEDIAN_BOUND}, {P95_BOUND}), confidence mean "
                f"|diff| {e16['confidence mean |diff|']:.2e} (bound "
                f"{FORWARD_BOUNDS['confidence mean |diff|']:.0e}); bf16 "
                f"sharded vs bf16 unsharded: depth bits differ at "
                f"{bits:.2%} of pixels, confidence {cbits:.2%}; zeroed halo: "
                + ", ".join(f"{k} {ef[k]:.2e}" for k in SPATIAL_BOUNDS)
                + f" (>= 2x bound: {caught}); per rank (bf16, median ms/map "
                f"of {SPATIAL_MAPS - 1} after one): "
                + "; ".join(f"rank {r}: {statistics.median(v['times'][1:]):.1f}"
                            f" ms/map, peak {v['peak_mb']:.0f} MiB "
                            f"({v['held_mb']:.0f} held before)"
                            for r, v in enumerate(ranks))
                + f" (unsharded peak {peak_mb:.0f} MiB, {held_mb:.0f} held "
                f"before); a map on rank 0: "
                f"launches {r0['launches']}, {r0['exchanges']['calls']} "
                f"all-reduces sending {r0['exchanges']['bytes'] / 2**20:.1f} "
                f"MiB; spawn to join "
                f"{spawn_s:.1f} s")
        if n == 2:
            eg = _map_errors(r0["groups"], ref_groups)
            line += (f"; ngroups={SPATIAL_GROUPS['ngroups']} (K6, "
                     f"{r0['groups k6']} launches on rank 0) f32 sharded vs "
                     f"unsharded: " + ", ".join(
                         f"{k} {eg[k]:.2e}" for k in SPATIAL_BOUNDS))
            failures += [f"groups {k} {eg[k]:.2e}" for k, b in
                         SPATIAL_BOUNDS.items() if eg[k] > b]
            if not r0["groups k6"]:
                failures.append("groups: K6 never launched")
        print(line + f"; {smi}", flush=True)
        failures += [f"n={n} f32 {k} {e32[k]:.2e}" for k, b in
                     SPATIAL_BOUNDS.items() if e32[k] > b]
        if not (e16["depth median"] <= MEDIAN_BOUND
                and e16["depth p95"] <= P95_BOUND
                and e16["confidence mean |diff|"]
                <= FORWARD_BOUNDS["confidence mean |diff|"]):
            failures.append(f"n={n} bf16 gate {e16}")
        if not caught:
            failures.append(f"n={n}: the zeroed halo stays within 2x {ef}")
        for r, v in enumerate(ranks):
            if not all(c > 0 for c in v["launches"].values()):
                failures.append(f"n={n} rank {r}: a kernel never launched "
                                f"{v['launches']}")
        require(all(math.isfinite(x) for v in (r0["f32"], r0["bf16"])
                    for x in (v["depth"].sum().item(),
                              v["confidence"].sum().item())),
                f"spatial n={n}: non-finite maps")
    require(not failures, "spatial: " + "; ".join(failures))
    band = k1_band_case(scene)
    print(f"spatial: K1 at stage 0, bf16, a rank's band launch (rank 1; "
          f"sources all-gathered to full height) vs the full launch "
          f"{band['full_device_ms']:.4f} ms device ({band['full_ms']:.4f} "
          f"wall): " + "; ".join(
              f"n={n} {v['shape']}: {v['device_ms']:.4f} ms device "
              f"({v['ms']:.4f} wall; plain "
              f"{v['plain_ms']:.2f}, bound {v['bound_ms']:.4f}), max |err| "
              f"{v['max_abs_err']:.2e}, the full launch's rows "
              f"{v['equals_full_rows']}" for n, v in band["bands"].items())
          + f"; {smi}", flush=True)
    spatial_cli_phase()
    return band


def spatial_cli_phase() -> None:
    """``python -m mdfnet_tpu_torch.cli.eval --spatial 2`` in a session of
    its own on a synthetic 1600x1200 DTU tree (two reference views): the
    crop aligned to 1152, rank 0 alone writing full-height finite maps."""
    from mdfnet_tpu_torch.data import (read_pair_file, read_pfm,
                                       write_dtu_eval_tree, write_pair_file)
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.utils.weights import save_checkpoint
    work = smoke_dir("smoke_spatial_cli")
    try:
        tree = os.path.join(work, "dtu1600x1200")
        write_dtu_eval_tree(tree, scans=(9,), nviews=NVIEWS,
                            height=SERVE_HEIGHT, width=WIDTH)
        _, pairs = read_pair_file(os.path.join(tree, "pair.txt"))
        write_pair_file(os.path.join(tree, "pair.txt"), pairs[:2])
        ckpt = os.path.join(work, "seed0.pth")
        save_checkpoint(build_model(seed=0, device=DEV), ckpt)
        outdir = os.path.join(work, "outputs")
        t0 = time.perf_counter()
        proc = run_session(
            [sys.executable, "-m", "mdfnet_tpu_torch.cli.eval", "-p", ckpt,
             "--root", work, "-o", outdir, "--scans", "9", "--spatial", "2"],
            timeout=SPATIAL_TIMEOUT)
        cli_s = time.perf_counter() - t0
        log = proc.stdout.strip().splitlines()
        require(proc.returncode == 0, "eval CLI --spatial 2 failed:\n"
                + "\n".join(log[-30:]))
        require(any("1184 -> 1152" in x for x in log),
                "eval CLI --spatial 2 did not align the crop to 1152")
        files = sorted(os.path.relpath(os.path.join(d, f), outdir)
                       for d, _, names in os.walk(outdir) for f in names)
        require(len(files) == 6, f"eval CLI --spatial 2 wrote {files}")
        for ref, _ in pairs[:2]:
            depth, _ = read_pfm(os.path.join(outdir, "scan9", "depth_est",
                                             f"{ref:08d}.pfm"))
            require(depth.shape == (SPATIAL_HEIGHT, WIDTH)
                    and np.isfinite(depth).all(),
                    f"view {ref}: depth {depth.shape} not finite/1152 rows")
        print(f"spatial CLI: eval --spatial 2 wrote 2 views ({len(files)} "
              f"files, rank 0 alone) in {cli_s:.1f} s; "
              f"{log[-1].split(': ', 1)[-1]}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# the final tiles (h, w) that --chain-tiles times the chain kernel at
CHAIN_TILE_SWEEP = ((8, 8), (8, 16), (16, 16), (8, 32), (16, 32), (32, 16),
                    (32, 32), (32, 48), (48, 32), (32, 64), (64, 32),
                    (48, 48), (64, 64))


def chain_tiles(root: str = ROOT) -> None:
    """Each chain call of the forward (chain_calls) on the chain kernel at
    every final tile of CHAIN_TILE_SWEEP that chain_plan takes (the chain
    put in conv_kernel.CHAIN_FUSED at that tile; device_ms, the launches
    and the most shared memory a block takes), beside the per-layer route,
    with the package of the checkout at ``root``: one line
    ``CHAIN_TILES {...}``, from which CHAIN_FUSED and CHAIN_CASE_TILES are
    set."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mdfnet_tpu_torch.ops.cuda import conv_kernel
    require(conv_kernel.__file__.startswith(root + os.sep),
            f"{conv_kernel.__file__} is not under {root}")
    out = {"root": root}
    for call, x, ws, sc, of, relus, res, fs in chain_calls(torch.bfloat16):
        key = (tuple((w.shape[-1], w.shape[1], w.shape[0]) for w in ws),
               relus, res, fs)

        def run(route, x=x, ws=ws, sc=sc, of=of, relus=relus, res=res,
                fs=fs):
            return conv_kernel.conv2d_chain(
                x, ws, sc, of, relu_flags=relus, residuals=res,
                final_stride=fs, route=route)
        row = {"layers": device_ms(lambda: run("layers")),
               "rule": conv_kernel.chain_route(x.dtype, *key),
               "rule tile": conv_kernel.CHAIN_FUSED.get(key)}
        for tile in CHAIN_TILE_SWEEP:
            plan = conv_kernel.chain_plan(*key, tile)
            if plan:
                with chain_tile(key, tile):
                    row[f"{tile[0]}x{tile[1]}"] = {
                        "ms": device_ms(lambda: run("fused")),
                        "smem": max(g.smem for g in plan),
                        "launches": [(g.first, g.last) for g in plan]}
        out[call] = row
        print(f"chain tiles {call}: {row}", flush=True)
    print("CHAIN_TILES " + json.dumps(out), flush=True)


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


def _device_events(fn, iters: int) -> dict:
    """Device time per call of ``fn`` by kernel (or copy) name
    (torch.profiler, CUPTI) over ``iters`` calls, after one call. CUPTI at
    times drops some of a trace's kernels (a reading of K1's train launch
    at 0.09 ms against 0.23 in the same call): each kernel of a call
    launches as often in every call, so a trace in which a kernel's count
    is not a multiple of ``iters`` is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out, whole = {}, True
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                out[e.key] = out.get(e.key, 0.0) + \
                    e.self_device_time_total / iters / 1e3
                whole = whole and e.count % iters == 0
        if whole:
            break
    return out


def kernel_device_ms(fn, kernel: str, iters: int = 10) -> float:
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``kernel`` ("": every kernel and copy of the call) (torch.profiler,
    CUPTI), over ``iters`` calls after one. A trace that holds none of
    them (CUPTI at times records no kernel of a short profile) is taken
    again, up to three times."""
    for _ in range(3):
        ms = sum(v for k, v in _device_events(fn, iters).items()
                 if kernel in k)
        if ms > 0:
            return ms
    raise RuntimeError(f"no {kernel} kernel in three traces")


def device_split(fn, iters: int = 10) -> dict:
    """Device time per call of ``fn`` by kernel or copy, each name cut to
    its function (no namespace, template or arguments)."""
    for _ in range(3):
        events = _device_events(fn, iters)
        if events:
            break
    else:
        raise RuntimeError("no kernel in three traces")
    out = {}
    for key, ms in events.items():
        name = re.split(r"[<(]", key.replace("(anonymous namespace)::", "")
                        .replace("void ", ""))[0].split("::")[-1].strip()
        name = name or key[:40]
        out[name] = out.get(name, 0.0) + ms
    return out


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def k9_device_ms(aggregate_kernel, root: str) -> None:
    """K9 (``aggregate_kernel``: a checkout's module) at the three DTU train
    stages in bf16 and f32 (k9_inputs): the stats kernel's two launches
    (split by kernel, and summed) and K1's train launch by device time (the
    median of three reads in turn, each read beside it), the
    f64 sums, a digest of the f32 mean and biased variance derived from them
    as ops/aggregate_train.py derives them, and a digest of K1's train
    output (volume and weight sum): one line ``K9_DEVICE_MS {...}``."""
    cases = []
    for stage, dt, args, bn in k9_inputs(train_batch()):
        def stats(args=args):
            return aggregate_kernel.rowsweep_stats(*args)

        def k1_train(args=args, bn=bn):
            return aggregate_kernel.rowsweep_aggregate_with_wsum(*args, *bn)
        sums = stats()
        # the batch statistics as ops/aggregate_train.py derives them
        b, _, h, w, _ = args[0].shape
        n = b * args[4].shape[1] * h * w
        mu = sums[:, 0] / n
        var_b = (sums[:, 1] / n - mu * mu).clamp_min(0.0)
        vol, wsum = k1_train()
        # three reads of each in turn, the median kept: a read can catch the
        # card's clock low (every kernel of its trace ~10% slower)
        splits, k1_ms = [], []
        for _ in range(3):
            splits.append(device_split(stats))
            k1_ms.append(kernel_device_ms(k1_train,
                                          "rowsweep_aggregate_kernel"))
        stats_ms = [sum(v for k, v in split.items()
                        if k.startswith("rowsweep_stats")) for split in splits]
        cases.append({
            "stage": stage, "dtype": str(dt)[6:],
            "stats_split": splits[stats_ms.index(statistics.median(stats_ms))],
            "stats_ms": statistics.median(stats_ms), "stats_reads": stats_ms,
            "k1_train_ms": statistics.median(k1_ms), "k1_train_reads": k1_ms,
            "sums": sums.cpu().tolist(),
            "mu_var_digest": _digest(torch.stack([mu.float(),
                                                  var_b.float()])),
            "k1_train_digest": _digest(torch.cat([vol.flatten(),
                                                  wsum.flatten()]))})
        print(f"K9 stage {stage} {str(dt)[6:]}: {cases[-1]}", flush=True)
        del vol, wsum
    print("K9_DEVICE_MS " + json.dumps({"root": root, "cases": cases}),
          flush=True)


def device_ms_mode(root: str) -> None:
    """K1's, K7's and K9's device time with the package of the checkout at
    ``root`` (say a parent commit's ``git archive``, whose kernels build
    under its own build/), and a digest of each output; run it for two
    checkouts in one call to compare them on one card (equal digests mean
    equal bits). K1 (its kernel alone, kernel_device_ms) at the three DTU
    eval stages in bf16: one line ``K1_DEVICE_MS {...}``. K7 (every kernel
    and copy of a call) at the three DTU train stages (k7_inputs) in bf16
    and f32, with its split by kernel (device_split), its wall per call,
    the device memory a call takes beyond its output, and
    grid_sampler_2d_backward's device time on the same samples: one line
    ``K7_DEVICE_MS {...}``. K9 at the same stages (k9_device_ms):
    ``K9_DEVICE_MS {...}``. Then the DTU train step (bf16, dense and
    fused): ms/step (median of 5 after 2), peak memory and device time
    (every kernel and copy of a step in a profile): ``TRAIN_STEP {...}``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mdfnet_tpu_torch.ops.cuda import aggregate_kernel, splat_kernel
    require(aggregate_kernel.__file__.startswith(root + os.sep),
            f"{aggregate_kernel.__file__} is not under {root}")
    gen = torch.Generator().manual_seed(0)
    ms, digests = [], []
    for a in k1_inputs(gen, dtu_scene(), torch.bfloat16):
        ms.append(kernel_device_ms(
            lambda a=a: aggregate_kernel.rowsweep_aggregate(*a),
            "rowsweep_aggregate_kernel"))
        digests.append(_digest(aggregate_kernel.rowsweep_aggregate(*a)))
    print("K1_DEVICE_MS " + json.dumps({"root": root, "stages_ms": ms,
                                        "digests": digests}), flush=True)
    cases = []
    for stage, dt, (g, x, y, h, w) in k7_inputs(train_batch()):
        def run(g=g, x=x, y=y, h=h, w=w):
            return splat_kernel.splat_2d(g, x, y, h, w)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - before - size(out)
        split = device_split(run)
        n, d, c = g.shape[0], g.shape[1], g.shape[-1]
        grid = torch.stack([(2.0 * x + 1.0) / w - 1.0,
                            (2.0 * y + 1.0) / h - 1.0], -1)
        grid = grid.reshape(n, d, h * w, 2).to(dt)
        img = torch.zeros(n, c, h, w, dtype=dt, device=DEV)
        g_nchw = g.reshape(n, d, h * w, c).permute(0, 3, 1, 2)
        library = kernel_device_ms(
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_nchw, img, grid, 0, 0, False, [True, False]), "")
        cases.append({"stage": stage, "dtype": str(dt)[6:],
                      "shape": list(g.shape), "ms": sum(split.values()),
                      "split": split, "wall_ms": cuda_ms(run),
                      "scratch_mib": scratch / 2**20,
                      "library_ms": library, "digest": _digest(out)})
        print(f"K7 stage {stage} {str(dt)[6:]}: {cases[-1]}", flush=True)
        del out, grid, img, g_nchw
    print("K7_DEVICE_MS " + json.dumps({"root": root, "cases": cases}),
          flush=True)
    k9_device_ms(aggregate_kernel, root)
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.train_lib import make_optimizer, poly_lr, train_step
    batch, steps = train_batch(), {}
    for impl in ("dense", "fused"):
        model = build_model(ModelConfig(warp_impl=impl),
                            compute_dtype="bfloat16", seed=0,
                            device=DEV).requires_grad_(True)
        opt = make_optimizer(model, poly_lr(1, 1e-3, 30, 0.9))

        def step(model=model, opt=opt):
            return train_step(model, opt, batch)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        steps[impl] = {"ms_step": statistics.median(times),
                       "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                       "device_ms": kernel_device_ms(step, "", iters=3)}
        del model, opt
    print("TRAIN_STEP " + json.dumps({"root": root, **steps}), flush=True)


def eval_profile_mode(root: str) -> None:
    """The bf16 eval forward (seed-0 weights, sharpened) with the package
    of the checkout at ``root``, at the DTU eval shape and at Tanks
    2048x1056 (11 views): ms/map (median of 6 after one), peak memory,
    device busy ms, ATen's elementwise and ``cat`` device ms (device_split,
    3 forwards) and the time by layer (CUDA events): one line
    ``EVAL_PROFILE {...}``. Run it for two checkouts in one call (parent,
    change, change, parent) to compare them on one card."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mdfnet_tpu_torch.data import make_batch
    from mdfnet_tpu_torch.models.registry import build_model
    require(build_model.__module__ == "mdfnet_tpu_torch.models.registry"
            and sys.modules[build_model.__module__].__file__.startswith(
                root + os.sep), f"the package is not the one under {root}")
    model = build_model(compute_dtype="bfloat16", seed=0, device=DEV)
    sharpen(model)
    out = {"root": root}
    for name, scene in (("dtu", dtu_scene()), ("tanks 2048", tanks_scene(
            TANKS_WIDTHS[1]))):
        batch = make_batch(scene, batch=1)
        args = [torch.from_numpy(batch[k]).to(DEV)
                for k in ("imgs", "extrinsics", "intrinsics", "depth_range")]
        model(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            model(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        split = device_split(lambda: model(*args), iters=3)
        layers, total = layer_ms(model, args)
        out[name] = {"ms_map": statistics.median(times[1:]),
                     "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                     "device_ms": sum(split.values()), **glue_ms(split),
                     "layers_ms": layers, "total_ms": total}
        del args, batch
    print("EVAL_PROFILE " + json.dumps(out), flush=True)


def sass_counts(lib_path, prefix: str) -> dict:
    """The special-function instructions of the kernels named ``prefix``*
    in the library's SASS (cuobjdump -sass), per instantiation: (MUFU.EX2,
    MUFU.RCP) in the code, each counted once wherever it sits, and each
    loop that holds an EX2 (a branch back to an earlier address) as
    (instructions, EX2, RCP) in its body, inner loops included, then the
    same on its common path: without the code that a branch jumps over to
    skip a call and no EX2 (a division's slow path)."""
    from mdfnet_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = _kernel_name(block.split("\n", 1)[0].strip())
        if not name.startswith(prefix):
            continue
        code = [(int(m[1], 16), m[2].strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        skipped = set()
        for a, op in code:
            jump = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", op)
            if jump and int(jump[1], 16) > a:
                over = [x for x in code if a < x[0] < int(jump[1], 16)]
                if (any(o.startswith("CALL") for _, o in over)
                        and not any("MUFU.EX2" in o for _, o in over)):
                    skipped.update(x for x, _ in over)

        def count(body):
            return (len(body), sum("MUFU.EX2" in o for o in body),
                    sum("MUFU.RCP" in o for o in body))
        loops = []
        for a, op in code:
            jump = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", op)
            if jump and int(jump[1], 16) <= a:
                body = [(x, o) for x, o in code if int(jump[1], 16) <= x <= a]
                if any("MUFU.EX2" in o for _, o in body):
                    loops.append(count([o for _, o in body])
                                 + count([o for x, o in body
                                          if x not in skipped]))
        out[name] = {"mufu": (block.count("MUFU.EX2"),
                              block.count("MUFU.RCP")), "loops": loops}
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
    if sys.argv[1:2] == ["--chain-tiles"] and len(sys.argv) <= 3:
        chain_tiles(*sys.argv[2:])
        return
    if sys.argv[1:2] == ["--device-ms"] and len(sys.argv) == 3:
        device_ms_mode(sys.argv[2])
        return
    if sys.argv[1:2] == ["--eval-profile"] and len(sys.argv) == 3:
        eval_profile_mode(sys.argv[2])
        return
    start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    if sys.argv[1:] == ["--spatial"]:
        from mdfnet_tpu_torch.ops.cuda import build
        build.build()
        spatial_phase(smi)
        print(f"total: {time.perf_counter() - start:.1f} s; {smi}")
        return
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
          + ", ".join(f"{k} {v['mufu']}" for k, v in sass_counts(
              lib_path, "rowsweep_aggregate_kernel").items()), flush=True)
    require(len(k1) == 12 and len(co1) == 12
            and not any(v[1] for v in (*k1.values(), *co1.values())),
            f"K1's or the co1 kernel's instantiations spill or are missing: "
            f"{k1} {co1}")
    # the stats kernel (3 G x 2 dtypes): registers, spills; its MUFU
    # instructions and the loops that hold them
    k9 = {k: v for k, v in kern.items()
          if k.startswith("rowsweep_stats_kernel")}
    print("build: the stats kernel (registers, spill store bytes; static "
          "EX2 + RCP; loops with an EX2 as instructions, EX2, RCP in the "
          "body, then on its common path): "
          + ", ".join(f"{k} {k9.get(k)}; {v['mufu']}; {v['loops']}"
                      for k, v in sass_counts(
                          lib_path, "rowsweep_stats_kernel").items()),
          flush=True)
    require(len(k9) == 6 and not any(v[1] for v in k9.values()),
            f"the stats kernel's instantiations spill or are missing: {k9}")

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
    k6_launches, groups_launches = alternatives_phase(scene, smi)
    kernels += [entry(n, info, report, k6_launches)
                for n, info in ALT_KERNELS.items()]
    tanks_phase(model, smi)
    tanks_serve_phase(model, smi)
    del model, args
    fusion_phase(smi)
    metric_phase(smi)

    batch = train_batch()
    report = check_train_kernels(batch)
    launches, tc, unfused_f32 = train_gate(batch)
    kernels += [entry(n, info, report, launches[info.get("counter", n)],
                      tc.get(info.get("counter", n)))
                for n, info in TRAIN_KERNELS.items()]
    kernels += [entry(n, info, report, groups_launches[info["counter"]])
                for n, info in GROUPS_KERNELS.items()]
    unfused_layers = learn_phase(batch, smi)
    train_cli_phase()
    launches = fused_gate(batch, unfused_f32)
    kernels += [entry(n, info, report, launches[n])
                for n, info in FUSED_KERNELS.items()]
    fused_learn_phase(batch, smi, unfused_layers)
    data_parallel_phase(smi)
    remat_phase(batch, smi)
    band = spatial_phase(smi)
    for k in kernels:
        if k["name"] == "rowsweep_aggregate":
            k["band"] = band

    print(f"total: {time.perf_counter() - start:.1f} s; {smi}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
