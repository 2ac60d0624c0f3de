"""The ``eval`` loop: a closed loop with one client, as the port's eval CLI
runs it. For each map the scene's float32 images, cameras and depth range
are in pinned host memory; they are copied to the card, ``CoreNet.forward``
runs, and the depth and confidence come back to host memory before the
next map starts.

The maps checked are drawn from the seed among the window's first
``check_within``, one scene each, and compared with the reference after
the window. Faults that a test or ``calibrate.py`` may plant: ``missed
tile`` (the last eighth of the rows never written) and ``stale answer``
(each map returns the previous map's answer).
"""
from __future__ import annotations

import time

import torch

from portbench import archs
from portbench.archs import mdfnet
from portbench.lib import harness as h

SHAPE = "eval"
# the loop's own spans; Loop.layers adds the architecture's layers
LABELS = ("input copy", "model call", "output copy")
# MDF-Net's layers, which metrics/other_ms.eval.py and other_ms.device.py
# read from this module by name: their cells run MDF-Net
LAYERS = mdfnet.LAYERS
BACKWARD = None
FAULTS = ("missed tile", "stale answer")


class Loop:
    def __init__(self, run):
        self.run = run
        shape = run.cfg[SHAPE]
        self.batch = shape["batch"]
        self.n = run.mix["scenes"]
        self.host = h.make_data(shape, run.mix, self.n * self.batch,
                                run.seed, run.device)
        self.arch = archs.of(run.cfg)
        self.layers = self.arch.LAYERS
        self.nstages = self.arch.stages(run.cfg)
        self.optimizer = self.previous = None
        gen = torch.Generator().manual_seed(run.seed)
        order = torch.randperm(run.mix["check_within"], generator=gen)
        # maps of different scenes, drawn from the seed
        picked, seen = [], set()
        for i in order.tolist():
            if i % self.n not in seen:
                picked.append(i)
                seen.add(i % self.n)
            if len(picked) == run.mix["checked"]:
                break
        self.checked = {i: None for i in picked}

    def item(self, i: int) -> dict:
        k = i % self.n
        return h.rows(self.host, k * self.batch, (k + 1) * self.batch)

    def attach(self, model):
        return model

    def one(self, model, i: int, check: bool = False):
        """One map: input copy, model call, output copy. Returns the host
        seconds of the model call and, when checked, the outputs."""
        run, spans = self.run, self.run.spans
        item = self.item(i)
        with spans("input copy"):
            args = [item[k].to(run.device, non_blocking=True)
                    for k in h.INPUTS]
        stages = self.arch.stage_hooks(model, self.nstages) \
            if check or run.fault else None
        with spans("model call"):
            t = time.perf_counter()
            out = model(*args)
            call = time.perf_counter() - t
        with spans("output copy"):
            answer = {"depth": out["depth"].float().cpu(),
                      "confidence": out["confidence"].float().cpu()}
        if stages is not None:
            answer["stage_depths"] = stages.close()
        if run.fault == "missed tile":       # the last eighth of the rows
            for key in ("depth", "confidence"):   # never written
                rows = answer[key].shape[-2]
                answer[key][..., rows - rows // 8:, :] = 0.0
        elif run.fault == "stale answer":    # the previous map's answer
            answer, self.previous = self.previous or answer, answer
        return call, answer if check else None

    def warmup(self, model) -> list:
        """The first maps, one of each shape and route; returns the
        seconds each took."""
        took = []
        for i in range(self.run.mix["warmup"]):
            t = time.perf_counter()
            self.one(model, i)
            took.append(time.perf_counter() - t)
        return took

    def window(self, model, seconds: float, min_items: int = 0) -> dict:
        lat, calls, i = [], [], 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds or i < min_items:
            t = time.perf_counter()
            call, kept = self.one(model, i, check=i in self.checked)
            lat.append(time.perf_counter() - t)
            calls.append(call)
            if kept is not None:
                self.checked[i] = kept
            i += 1
        return {"items": i, "seconds": time.perf_counter() - start,
                "latencies": lat, "calls": calls}

    def traced(self, model, n: int) -> None:
        for j in range(n):
            self.one(model, j)

    def span_hooks(self, model) -> list:
        return self.run.spans.hook_modules(model, self.layers)

    def check(self, state: dict) -> dict:
        """The sampled maps against the reference: per map the mean, the
        median and the 90th percentile of the absolute depth error of each
        stage and of the final depth over the depth range, and of the
        absolute confidence error; the worst map's."""
        run = self.run
        model = h.build_reference(run.cfg, state, run.device)
        ref = h.reference_module(run.cfg)
        names = [f"depth{s}" for s in range(self.nstages)] + ["depth",
                                                              "confidence"]
        worst = {k + tail: 0.0 for k in names
                 for tail in ("", "_median", "_p90")}
        missing = [i for i, v in self.checked.items() if v is None]
        with ref.exact_f32():
            for i, got in self.checked.items():
                if got is None:
                    continue
                item = self.item(i)
                want = model(*[item[k].to(run.device) for k in h.INPUTS])
                span = (item["depth_range"][:, 1] - item["depth_range"][:, 0]
                        ).to(run.device).reshape(-1, 1, 1)
                pairs = {f"depth{s}": (got["stage_depths"][s],
                                       want["stage_depths"][s], span)
                         for s in range(self.nstages)}
                pairs["depth"] = (got["depth"], want["depth"], span)
                pairs["confidence"] = (got["confidence"], want["confidence"],
                                       1.0)
                for k, (a, b, scale) in pairs.items():
                    err = ((a.to(run.device) - b).abs() / scale).flatten()
                    for tail, value in (("", err.mean()),
                                        ("_median", err.median()),
                                        ("_p90", torch.quantile(err, 0.9))):
                        worst[k + tail] = max(worst[k + tail], float(value))
        return {"readings": worst, "missing": len(missing),
                "checked": len(self.checked)}
