"""Spans placed by the benchmark, the profiler around a sub-window, and the
reading of its trace: which device operations each span launched, how long
the device was busy, and what the host was doing while it was idle.

The spans are ``record_function`` ranges named ``portbench/<name>``, opened
from the benchmark's own files: around its calls into the program and in
forward hooks on the port's top-level modules. A device operation belongs
to the spans that were open on the host thread that launched it, found
through the profiler's correlation of each kernel, copy or set with its
launch. The autograd engine launches the backward from a thread of its own,
so an operation launched from another thread than the loop's belongs to the
backward.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
from dataclasses import dataclass, field

import torch

PREFIX = "portbench/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Opens and closes named spans; a no-op unless ``on``."""

    def __init__(self):
        self.on = False
        self._open: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield

    def enter(self, name: str) -> None:
        if self.on:
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self._open.append(rf)

    def exit(self) -> None:
        if self.on and self._open:
            self._open.pop().__exit__(None, None, None)

    def hook_modules(self, model, names) -> list:
        """A span around each named submodule's forward; returns the hook
        handles."""
        handles = []
        for name in names:
            mod = model.get_submodule(name)
            handles.append(mod.register_forward_pre_hook(
                lambda _m, _a, name=name: self.enter(name)))
            handles.append(mod.register_forward_hook(
                lambda _m, _a, _o: self.exit()))
        return handles


@contextlib.contextmanager
def profiled(path: str, cuda: bool = True):
    """torch.profiler over the host and (``cuda``) the card for the block;
    its trace is written to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)


@dataclass
class DeviceOp:
    name: str
    start: float          # us
    dur: float            # us
    spans: tuple          # span names open at launch, outermost first
    main: bool            # launched from the loop's thread


@dataclass
class Trace:
    window: tuple          # (start, end) us of the "window" span
    ops: list              # DeviceOp within the window
    spans: dict = field(default_factory=dict)   # name -> [(start, end)]
    busy_us: float = 0.0
    gaps: list = field(default_factory=list)    # (start, end) us, idle


def read_trace(path: str, main_tid: int | None = None) -> Trace:
    """Read a trace written by :func:`profiled` whose loop opened a
    ``window`` span on the thread ``main_tid`` (default: the thread that
    opened it)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    annotations, launches, device = [], {}, []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            annotations.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                e["name"][len(PREFIX):], e["tid"]))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e["tid"])
        elif cat in DEVICE_CATS:
            device.append(e)
    windows = [a for a in annotations if a[2] == "window"]
    if len(windows) != 1:
        raise ValueError(f"the trace has {len(windows)} window spans")
    w0, w1, _, wtid = windows[0]
    main_tid = wtid if main_tid is None else main_tid
    by_tid: dict = {}
    spans: dict = {}
    for a in annotations:
        by_tid.setdefault(a[3], []).append(a)
        spans.setdefault(a[2], []).append((a[0], a[1]))
    for lst in by_tid.values():
        lst.sort()
    ops = []
    for e in device:
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if start + dur <= w0 or start >= w1:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            names, main = (), True
        else:
            names = tuple(a[2] for a in by_tid.get(launch[1], ())
                          if a[0] <= launch[0] <= a[1])
            main = launch[1] == main_tid
        ops.append(DeviceOp(e["name"], start, dur, names, main))
    ops.sort(key=lambda o: o.start)
    trace = Trace((w0, w1), ops, spans)
    trace.busy_us, trace.gaps = _busy(ops, w0, w1)
    return trace


def _busy(ops, w0, w1) -> tuple[float, list]:
    """The union of the operations' intervals within [w0, w1], and the
    idle gaps between them."""
    busy, gaps, at = 0.0, [], w0
    for o in ops:
        s, e = max(o.start, w0), min(o.start + o.dur, w1)
        if e <= at:
            continue
        if s > at:
            gaps.append((at, s))
            at = s
        busy += e - at
        at = e
    if at < w1:
        gaps.append((at, w1))
    return busy, gaps


def host_label(trace: Trace, t: float, labels: tuple) -> str:
    """The innermost of ``labels`` whose span was open at time ``t`` on any
    thread, or "other"."""
    best, best_len = "other", float("inf")
    for name in labels:
        for s, e in trace.spans.get(name, ()):
            if s <= t <= e and e - s < best_len:
                best, best_len = name, e - s
    return best


def breakdown(trace: Trace, labels: tuple, backward_label: str | None = None
              ) -> dict:
    """The device operations with the most time, by name, and the idle
    time by what the host was doing (the innermost of ``labels`` open at
    the middle of each gap; with ``backward_label``, a gap inside a step
    while another thread launches is that label's), in seconds."""
    by_name: dict = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur * 1e-6
    idle: dict = {}
    other = _other_thread_ranges(trace) if backward_label else []
    starts = [r[0] for r in other]
    for s, e in trace.gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and other[i][0] <= mid <= other[i][1]:
            label = backward_label
        else:
            label = host_label(trace, mid, labels)
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def _other_thread_ranges(trace: Trace) -> list:
    """Per step span, the time from the first to the end of the last
    operation launched from another thread than the loop's."""
    ranges = []
    for s, e in trace.spans.get("train step", ()):
        inside = [o for o in trace.ops if not o.main and s <= o.start <= e]
        if inside:
            ranges.append((min(o.start for o in inside),
                           max(o.start + o.dur for o in inside)))
    return sorted(ranges)


def trace_path() -> str:
    """Where the traced run writes its trace: under TMPDIR, named by the
    process (a scratch file, deleted after it is read)."""
    base = os.environ.get("TMPDIR") or os.path.join(os.getcwd(), "build")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"portbench_trace_{os.getpid()}_"
                              f"{threading.get_ident()}.json")
