"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device  — needs CUDA; prints the card's name and power limit;
  2. build   — compiles the hand-written kernels (ops/cuda/csrc) with nvcc;
  3. kernels — each kernel vs its plain PyTorch version at the DTU stage
     shapes, bf16 and f32, with times from CUDA events;
  4. forward — the CoreNet eval forward at 1600x1184, 5 views, B=1, bf16
     convs, seeded random weights with a sharpened posterior: every kernel's
     launch counter must move, and the output must agree with the plain f32
     forward on the card: depth (median <= 0.4%, p95 <= 3% of the depth
     range, the bounds of tools/check_fused_oracle.py), confidence, and each
     stage's cost and probability volumes (FORWARD_BOUNDS);
  5. serve   — ``python -m mdfnet_tpu_torch.cli.eval`` on a synthetic DTU
     eval tree (1600x1200 cropped to 1184, 3 reference views);
  6. train kernels — the training step's kernels at the DTU train shapes
     (640x512, 5 views, batch 4): the sample (K6) and splat (K7) kernels vs
     their plain versions at stages 0 and 2, the splat run twice with
     bit-identical output, and each differentiable conv's (K8) output,
     input gradient and weight gradient vs plain autograd on the plain conv;
  7. train gate — one train step at that configuration on the kernels in
     bf16 against the plain versions in f32 (loss, each stage's cost and
     probability volume, the gradients' cosines: STEP_BOUNDS_BF16), and on
     the kernels in f32 against the plain versions in f32 (loss and every
     parameter's gradient: STEP_BOUNDS_F32); every launch counter of the
     bf16 step must move;
  8. learn   — 20 Adam steps on one batch: finite losses, the last below 0.9
     x the first; ms/step, device time and idle share (torch.profiler),
     peak memory, and one step's time by layer (CUDA events);
  9. train CLI — ``python -m mdfnet_tpu_torch.train --fast`` for one epoch on
     a synthetic DTU train tree; its checkpoint loads strictly into the eval
     model, which then runs.

The line before the last is one JSON object with every kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
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
KERNELS = {   # wrapper name -> its CUDA source and the TPU kernel it replaces
    "rowsweep_aggregate": dict(
        source=_SRC + "rowsweep_aggregate.cu",
        replaces="mdfnet_tpu/ops/pallas/aggregate_kernel.py:427"),
    "conv3d_bn_act": dict(
        source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv3d_kernel.py:577"),
    "trconv3d_bn_act": dict(
        source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv3d_kernel.py:741"),
    "conv2d_bn_act": dict(
        source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv2d_kernel.py:242"),
    "conv2d_chain": dict(
        source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv2d_kernel.py:654"),
}
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
        source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv3d_vjp.py:58", counter="conv3d_dgrad"),
    "trconv3d_train": dict(
        source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv3d_vjp.py:112",
        counter="trconv3d_dgrad"),
    "conv2d_train": dict(
        source=_SRC + "conv_bn_act.cu",
        replaces="mdfnet_tpu/ops/pallas/conv2d_vjp.py:45", counter="conv2d_dgrad"),
}
# the reference's training configuration: DTU train 640x512, 5 views, batch 4
TRAIN_HEIGHT, TRAIN_WIDTH, TRAIN_BATCH = 512, 640, 4
# Step gates at this configuration, each bound ~3x what an H100 gives
# without a fault (PERF.md section 2), and below what each of five injected
# faults gives there: a zeroed corner tap of every conv3d, of every
# transposed conv, of every 3x3 conv2d or of ProbConv, or a 1-pixel shift of
# the sample kernel's taps. Every fault exceeds the loss bound of either gate.
# bf16 kernels vs plain f32: bf16 rounding makes single gradients noisy at
# seeded weights (median per-parameter relative error 7e-2 from rounding
# alone; train-mode BN backprop cancels), so the bf16 gate bounds the loss,
# each stage's cost volume (mean |diff| / std) and probability volume
# (mean |diff|), and the median per-parameter gradient cosine.
STEP_BOUNDS_BF16 = {
    "loss": 1e-4, "cost 0": 0.12, "cost 1": 0.09, "cost 2": 0.075,
    "prob 0": 2.6e-3, "prob 1": 2.8e-3, "prob 2": 7.7e-3,
}
MIN_MEDIAN_COS_BF16 = 0.996
# f32 kernels vs plain f32 differ by summation order only, which the
# cancelling scalar DepthWeight BatchNorm gradients amplify (4.2e-2 relative
# at most; the median parameter 7e-4): every parameter's gradient is bounded,
# and their median more tightly (the faults give >= 5.6e-2).
STEP_BOUNDS_F32 = {"loss": 1e-5, "grad rel err": 0.12,
                   "median grad rel err": 2e-3}
MIN_COS_F32 = 0.9997


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


def dtu_scene():
    """The synthetic DTU-size scene: a textured tilted plane seen by 5
    cameras at 1600x1184 (DTU-like focal, ~1.8 x width)."""
    from mdfnet_tpu_torch.data import make_plane_scene
    return make_plane_scene(height=HEIGHT, width=WIDTH, nviews=NVIEWS,
                            tilt=0.05, focal=1.8 * WIDTH)


def kernel_cases(gen, scene):
    """(kernel name, dtype, callable(plain) -> tensor) at DTU stage shapes;
    the first case of each kernel is its timed, main-path shape."""
    from mdfnet_tpu_torch import geometry
    from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import rowsweep_aggregate
    from mdfnet_tpu_torch.ops.cuda.conv_kernel import (
        conv2d_bn_act, conv2d_chain, conv3d_bn_act, trconv3d_bn_act)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(DEV)

    intr = torch.from_numpy(scene.intrinsics)[None].to(DEV)
    extr = torch.from_numpy(scene.extrinsics)[None].to(DEV)
    # (h, w) at stage s = 0, 1, 2 (1/8, 1/4, 1/2 resolution)
    hw = [(HEIGHT >> (3 - s), WIDTH >> (3 - s)) for s in range(3)]
    (h8, w8), (h4, w4), (h2, w2) = hw
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        # K1 — stage 0 (uniform planes), stages 1-2 (per-pixel planes); S=4
        for stage, ((h, w), d, g) in enumerate(zip(hw, NDEPTHS, NGROUPS)):
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
            cases.append(("rowsweep_aggregate", dt, lambda p, a=(
                src, ref, src_projs, ref_proj, hyp.to(DEV), k0, *sc):
                rowsweep_aggregate(*a, plain=p)))

        def epi(co):
            return rnd(co, scale=0.2).abs() + 0.5, rnd(co, scale=0.1)

        # K2 — stage-0 U-Net conv01_0 (stride 1) and conv12_0 (stride 2),
        # stage-2 ProbConv (Co = 1)
        for shape, co, s in (((1, NDEPTHS[0], h8, w8, NGROUPS[0]), 16, 1),
                             ((1, NDEPTHS[0], h8, w8, 16), 32, 2),
                             ((1, NDEPTHS[2], h2, w2, 8), 1, 1)):
            x = rnd(*shape).to(dt)
            wt = rnd(co, shape[-1], 3, 3, 3, scale=0.1).to(dt)
            cases.append(("conv3d_bn_act", dt, lambda p, x=x, wt=wt, co=co,
                          s=s, e=epi(co): conv3d_bn_act(
                              x, wt, *e, stride=s, relu=co > 1, plain=p)))
        # K3 — stage-0 conv10 with its skip add; stage-1 conv343_2
        for shape, co in (((1, NDEPTHS[0] // 2, h8 // 2, w8 // 2, 32), 16),
                          ((1, NDEPTHS[1] // 8, h4 // 8, w4 // 8, 64), 32)):
            x = rnd(*shape).to(dt)
            wt = rnd(shape[-1], co, 3, 3, 3, scale=0.1).to(dt)
            res = rnd(1, 2 * shape[1], 2 * shape[2], 2 * shape[3], co).to(dt)
            cases.append(("trconv3d_bn_act", dt, lambda p, x=x, wt=wt, r=res,
                          e=epi(co): trconv3d_bn_act(x, wt, *e, residual=r,
                                                     plain=p)))
        # K4 — backbone conv23_0 (5x5 stride 2), lat2 (1x1 + residual),
        # refine's C->1 tail (f32 out)
        x = rnd(NVIEWS, h2, w2, 16).to(dt)
        w5 = rnd(32, 16, 5, 5, scale=0.05).to(dt)
        cases.append(("conv2d_bn_act", dt, lambda p, x=x, wt=w5, e=epi(32):
                      conv2d_bn_act(x, wt, *e, stride=2, plain=p)))
        w1 = rnd(64, 16, 1, 1, scale=0.2).to(dt)
        r1 = rnd(NVIEWS, h2, w2, 64).to(dt)
        cases.append(("conv2d_bn_act", dt, lambda p, x=x, wt=w1, r=r1,
                      e=epi(64): conv2d_bn_act(x, wt, *e, relu=False,
                                               residual=r, plain=p)))
        xt = rnd(1, HEIGHT, WIDTH, 8).to(dt)
        wt1 = rnd(1, 8, 3, 3, scale=0.2).to(dt)
        cases.append(("conv2d_bn_act", dt, lambda p, x=xt, wt=wt1, e=epi(1):
                      conv2d_bn_act(x, wt, *e, relu=False,
                                    out_dtype=torch.float32, plain=p)))
        # K5 — the full-res backbone trunk (3->8, 8->8, 8->16 5x5 stride 2)
        # and refine's half-res stack (Res skips, 0.1 scale)
        xi = rnd(NVIEWS, HEIGHT, WIDTH, 3).to(dt)
        ws = [rnd(8, 3, 3, 3, scale=0.3).to(dt),
              rnd(8, 8, 3, 3, scale=0.2).to(dt),
              rnd(16, 8, 5, 5, scale=0.1).to(dt)]
        es = [epi(8), epi(8), epi(16)]
        cases.append(("conv2d_chain", dt, lambda p, x=xi, ws=ws, es=es:
                      conv2d_chain(x, ws, [e[0] for e in es],
                                   [e[1] for e in es], final_stride=2,
                                   plain=p)))
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
                                     None), plain=p)))
    return cases


def check_kernels(scene):
    gen = torch.Generator().manual_seed(0)
    report = {}
    for name, dt, fn in kernel_cases(gen, scene):
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
        if dt == torch.bfloat16 and "ms" not in entry:
            entry["ms"] = cuda_ms(lambda: fn(False))
            entry["plain_ms"] = cuda_ms(lambda: fn(True), iters=3)
            line += f"; {entry['ms']:.3f} ms vs plain {entry['plain_ms']:.3f} ms"
        print(line, flush=True)
        require(rel <= REL_TOL[dt] and np.isfinite(err),
                f"{name} disagrees with its plain version")
    return [dict(name=n, route="cuda", **KERNELS[n], **report[n])
            for n in KERNELS]


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

    for c in counters:
        for k in c:
            c[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # the eval path's kernels (the *_dgrad counters belong to training)
    launches = {k: v for c in counters for k, v in c.items() if k in KERNELS}
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")

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
    return model, launches


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
    """(name, dtype, run(plain) -> result, time(plain) -> ms) at the DTU
    train shapes; the first case of each name is its timed, main-path shape
    (bf16). K8 results are (output, d_input, d_weight): the kernel Function
    against plain autograd on the plain conv."""
    import torch.nn.functional as F
    from mdfnet_tpu_torch import geometry
    from mdfnet_tpu_torch.ops.cuda import exact_cuda_math
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
        for dt in (torch.bfloat16, torch.float32):
            img = rnd(b * s, h, w, g).to(dt)
            gr = rnd(b * s, d, h, w, g).to(dt)
            sample = (lambda p, img=img, x=x, y=y: sample_2d(img, x, y, plain=p))
            splat = (lambda p, gr=gr, x=x, y=y, h=h, w=w:
                     splat_2d(gr, x, y, h, w, plain=p))
            cases += [("sample_2d", dt, sample,
                       lambda p, f=sample: cuda_ms(lambda: f(p))),
                      ("splat_2d", dt, splat,
                       lambda p, f=splat: cuda_ms(lambda: f(p)))]

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
    # K8 — stage-0 U-Net conv01_0 (s1), conv12_0 (s2), conv232_3 (the
    # transposed conv), ProbConv (Co = 1); full-res backbone conv01_1 (3x3
    # s1) and conv12_0 (5x5 s2: its input gradient is a library call); lat2
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
            cases.append((kind, dt, grads, backward_ms))
    return cases


def check_train_kernels(batch):
    from mdfnet_tpu_torch.ops.cuda.splat_kernel import splat_2d
    gen = torch.Generator().manual_seed(1)
    report = {}
    for name, dt, run, timer in train_kernel_cases(gen, batch):
        got, ref = run(False), run(True)
        torch.cuda.synchronize()
        err, rel = _rel_err(got, ref)
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        shape = tuple((got[0] if isinstance(got, tuple) else got).shape)
        line = (f"train kernel {name} {str(dt)[6:]} {shape}: max_abs_err "
                f"{err:.3e} rel {rel:.3e} (tol {REL_TOL[dt]:.0e})")
        if name == "splat_2d":
            again = run(False)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    "splat_2d: two launches on the same inputs differ")
            line += "; two launches bit-identical"
        if dt == torch.bfloat16 and "ms" not in entry:
            entry["ms"], entry["plain_ms"] = timer(False), timer(True)
            line += f"; {entry['ms']:.3f} ms vs plain {entry['plain_ms']:.3f} ms"
            if name.endswith("_train"):
                line += " (input gradient)"
        print(line, flush=True)
        require(rel <= REL_TOL[dt] and np.isfinite(err),
                f"{name} disagrees with its plain version")
        del got, ref
    return report


def _step(dtype: str, plain: bool, batch, *, launches=None):
    """One train step's loss, gradients and per-stage volumes from the
    seed-0 weights, convs in ``dtype`` ("bfloat16" or "float32").
    ``launches``: the counters to zero before the step and read after it
    (the main path's run)."""
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.train_lib import loss_and_grads
    model = build_model(compute_dtype=dtype, seed=0, device=DEV) \
        .requires_grad_(True)
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


def train_gate(batch):
    from mdfnet_tpu_torch.ops.cuda import (conv_kernel, splat_kernel,
                                           warp_kernel)
    counters = (warp_kernel.LAUNCHES, splat_kernel.LAUNCHES,
                conv_kernel.LAUNCHES)
    loss_b, grads_b, vols_b, launches = _step("bfloat16", False, batch,
                                              launches=counters)
    step_ids = [k for k in launches if k != "conv2d_chain"]
    require(all(launches[k] > 0 for k in step_ids),
            f"a kernel of the train step never launched: {launches}")
    loss_p, grads_p, vols_p, _ = _step("float32", True, batch)
    # bf16 kernels vs plain f32
    diffs = {"loss": abs(loss_b - loss_p) / abs(loss_p)}
    for key, r in vols_p.items():
        d = (vols_b[key] - r).abs().mean().item()
        diffs[key] = d / r.std().item() if key.startswith("cost") else d
    errs, coss = _grad_stats(grads_b, grads_p)
    med_cos = float(np.median(list(coss.values())))
    print(f"train gate bf16 kernels vs plain f32 ({TRAIN_WIDTH}x{TRAIN_HEIGHT}"
          f"x{NVIEWS}, batch {TRAIN_BATCH}): loss {loss_b:.4f} vs "
          f"{loss_p:.4f}; " + ", ".join(
              f"{k} {v:.2e} (bound {STEP_BOUNDS_BF16[k]:.1e})"
              for k, v in diffs.items())
          + f"; gradients over {len(errs)} parameters: rel err median "
          f"{np.median(list(errs.values())):.2e} max {max(errs.values()):.2e}"
          f" ({max(errs, key=errs.get)}), cosine median {med_cos:.4f} (bound "
          f">= {MIN_MEDIAN_COS_BF16}) min {min(coss.values()):.4f}; launches "
          f"{launches}", flush=True)
    for k, v in diffs.items():
        require(v <= STEP_BOUNDS_BF16[k],
                f"train gate bf16: {k} {v:.2e} > {STEP_BOUNDS_BF16[k]:.1e}")
    require(med_cos >= MIN_MEDIAN_COS_BF16,
            f"train gate bf16: median gradient cosine {med_cos:.4f}")
    del grads_b, vols_b
    # f32 kernels vs plain f32: every parameter
    loss_k, grads_k, _, _ = _step("float32", False, batch)
    errs, coss = _grad_stats(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(errs, key=errs.get)
    med_err = float(np.median(list(errs.values())))
    print(f"train gate f32 kernels vs plain f32: loss rel {loss_rel:.2e} "
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
    return launches


def learn_phase(batch, smi):
    """20 Adam steps on one batch (bf16 kernels): the loss falls; ms/step
    (median after 2 warm-up steps), profiled device time and idle share,
    peak memory, and one step's time by layer."""
    from mdfnet_tpu_torch.models.registry import build_model
    from mdfnet_tpu_torch.train_lib import make_optimizer, poly_lr, train_step
    model = build_model(compute_dtype="bfloat16", seed=0, device=DEV) \
        .requires_grad_(True)
    opt = make_optimizer(model, poly_lr(1, 1e-3, 30, 0.9))
    losses, times = [], []
    for i in range(20):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(model, opt, batch)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms_step = statistics.median(times[2:])
    busy, wall_us, top = device_profile(
        lambda: train_step(model, opt, batch), 14)
    print(f"learn: losses {[round(v, 2) for v in losses]}", flush=True)
    print(f"train step {TRAIN_WIDTH}x{TRAIN_HEIGHT}x{NVIEWS} batch "
          f"{TRAIN_BATCH} bf16 on {smi}: {ms_step:.2f} ms/step (median of "
          f"{len(times) - 2}; runs {[round(t, 1) for t in times]}), peak "
          f"{peak_mb:.0f} MiB; profiled step: device busy {busy / 1e3:.2f} ms "
          f"of {wall_us / 1e3:.2f} ms wall (idle {1 - busy / wall_us:.1%}); "
          f"estimated idle of an unprofiled step (vs its median) "
          f"{1 - busy / 1e3 / ms_step:.1%}; top: {top}", flush=True)
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < 0.9 * losses[0], f"no learning: {losses}")
    train_layers(model, opt, batch)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
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
    print(f"build: {build_s:.1f} s -> {os.path.relpath(lib_path, ROOT)}; "
          f"{len(kern)} kernels, most registers {kern.get(most, (0,))[0]} "
          f"({most}); spill stores: {', '.join(spills) or 'none'}",
          flush=True)

    scene = dtu_scene()
    kernels = check_kernels(scene)
    model, launches = forward_phase(build_s, scene)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    serve_phase(model)
    del model

    batch = train_batch()
    report = check_train_kernels(batch)
    launches = train_gate(batch)
    for name, info in TRAIN_KERNELS.items():
        info = dict(info)
        counter = info.pop("counter", name)
        kernels.append(dict(name=name, route="cuda", **info, **report[name],
                            launches=launches[counter]))
    learn_phase(batch, smi)
    train_cli_phase()

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
