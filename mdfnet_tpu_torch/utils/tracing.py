"""Spans of the port: named, nested intervals of host time at its layer
boundaries, to find where the host's time goes.

    with tracing.span("prep"):
        w = weight.to(dtype)

Off, the default, ``span`` checks a module global and whether a
``torch.profiler`` runs, and returns one shared no-op object: nothing is
recorded, nothing is allocated. Two things turn spans on, alone or together:

- ``with tracing.recording() as spans:`` keeps every span opened on any
  thread while it lasts: ``spans`` holds a :class:`Span` (name, parent,
  tid, start_ns, end_ns) per span on ``time.perf_counter_ns``, in the order
  they were opened. ``parent`` is the index of the innermost span open on
  the same thread at its start, -1 at the top, so the spans that the
  autograd engine opens on its own thread nest under that thread's spans.
- a running ``torch.profiler``: each span is also a profiler range named
  ``mdf/<name>`` (the RecordFunction that ``record_function`` opens), so
  it lands in the Chrome trace beside the operations it launched.
  ``start_ns + spans.offset_ns`` is the span's time on the trace's clock,
  its ``ts`` (us) x 1000 plus its ``baseTimeNanoseconds``.
  :func:`read_trace` reads such a trace back.

Neither writes anything: a recording stays in memory, and the profiler's
own export writes the trace.

The spans (``span`` is called at these sites):

- ``forward`` (``models/core.py`` CoreNet, eval and train), inside it
  ``backbone``, one ``stage`` a stage (inside it ``hypotheses``,
  ``aggregate``, ``regular``, ``regress``), ``refine``, and in eval
  ``confidence``;
- ``kernel/<entry>``: the host path of one launch of a hand-written kernel,
  ``<entry>`` its C entry point less ``mdf_`` (``ops/cuda/build.py``
  ``SIGNATURES``): one span a step of the launch counters (``LAUNCHES``);
- ``prep``: a kernel operand computed, on every call, from the parameters
  alone (a weight cast, a folded BatchNorm, a packed weight layout and its
  f32 scale and offset); nested in a ``kernel/*`` span where the wrapper
  packs it;
- ``train_step`` (``train_lib``), inside it ``forward``, ``loss``,
  ``backward``, ``reduce`` (with a process group) and ``optimizer``;
- ``vjp/<op>`` (``conv3d``, ``trconv3d``, ``conv2d``, ``aggregate``,
  ``sample``): the backward of the port's own ``autograd.Function``s,
  on the thread the autograd engine runs it on;
- ``graph/<segment>`` (``models/graphs.py``): one replay of one segment's
  CUDA graph in the eval forward (``backbone``, ``hypotheses.<s>``,
  ``aggregate.<s>``, ``cast.<s>``, ``regular.<s>``, ``regress.<s>``,
  ``refine``, ``confidence``); the module segments' spans lie inside the
  module's call.

Beside the kernels' launch counters (``LAUNCHES`` in ``ops/cuda``),
:data:`GRAPHS` counts the eval forward's CUDA graphs: ``captures``,
``replays`` (forwards replayed), ``eager`` forwards by reason
(``first_call`` of a key, ``train``, ``cpu``, ``plain``, ``halo``, and
``hooks``: a forward hook below a segment or a global one) and
``pool_bytes``, what the kept graphs' captures added to
``torch.cuda.memory_reserved`` (their pools and static inputs).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

PREFIX = "mdf/"
# the CUDA runtime calls that block the host until the device catches up
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
GRAPHS = {"captures": 0, "replays": 0,
          "eager": dict.fromkeys(("first_call", "train", "cpu", "plain",
                                  "halo", "hooks"), 0),
          "pool_bytes": 0}


class Span(NamedTuple):
    name: str
    parent: int          # index of the enclosing span on this thread, or -1
    tid: int             # threading.get_ident() of the opening thread
    start_ns: int        # time.perf_counter_ns()
    end_ns: int          # 0 if still open when the recording stopped


class Spans(list):
    """A recording's spans; ``offset_ns`` maps their clock onto the wall
    clock of torch.profiler's Chrome traces."""
    offset_ns: int = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
# the profiler's range for a span: the C++ RecordFunction that
# ``record_function`` also opens, without its two dispatched operators
# (an eighth of the host cost); the trace files it as a ``cpu_op``
_annotation = torch._C._profiler._RecordFunctionFast


class _Recorder:
    """One recording: every span by the number it drew when it opened
    (``entries``: [name, parent, tid, start_ns, end_ns]) and each thread's
    open spans on a stack of its own (``stacks``, by thread id). Drawing
    from ``ids`` and storing under a new key need no lock."""

    def __init__(self):
        self.spans = Spans()
        self.spans.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.entries: dict = {}
        self.stacks: dict = {}
        self.ids = itertools.count()

    def finish(self) -> None:
        """The entries as :class:`Span`, in the order they opened, their
        parents renumbered to positions."""
        order = sorted(self.entries)
        at = {i: k for k, i in enumerate(order)}
        self.spans[:] = [Span(e[0], at.get(e[1], -1), *e[2:])
                         for e in (self.entries[i] for i in order)]


_recorder: _Recorder | None = None


class _On:
    __slots__ = ("name", "recorder", "entry", "stack", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the recording's clock is read first, the profiler's inside its
        # enter: a first enter can take a millisecond after its reading
        rec = self.recorder = _recorder
        if rec is not None:
            tid = threading.get_ident()
            stack = rec.stacks.get(tid)
            if stack is None:
                stack = rec.stacks[tid] = []
            index = next(rec.ids)
            self.entry = rec.entries[index] = [
                self.name, stack[-1] if stack else -1, tid,
                time.perf_counter_ns(), 0]
            stack.append(index)
            self.stack = stack
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = _annotation(PREFIX + self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.recorder is not None:
            # after the recording ended this reaches only its entries
            self.entry[4] = time.perf_counter_ns()
            self.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager around one span called ``name``; the shared no-op
    unless a recording or a profiler is on."""
    if _recorder is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def spanned(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record every span opened on any thread inside the block; yields the
    :class:`Spans`, whose entries are :class:`Span` once the block ends.
    One recording at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("tracing: a recording is already on")
    recorder = _recorder = _Recorder()
    try:
        yield recorder.spans
    finally:
        _recorder = None
        recorder.finish()


def summary(spans) -> dict:
    """Per span name: {"count", "total_ms", "self_ms"}, self being the
    duration less the part its child spans cover."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: dict = {}
    for s, inner in zip(spans, child_ns):
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += (s.end_ns - s.start_ns) / 1e6
        row["self_ms"] += (s.end_ns - s.start_ns - inner) / 1e6
    return out


def format_summary(spans, per: int = 1) -> str:
    """:func:`summary` as lines, the most total time first, each time
    divided by ``per`` (maps or steps)."""
    rows = sorted(summary(spans).items(), key=lambda kv: -kv[1]["total_ms"])
    return "\n".join(f"{name:28s} {r['count'] / per:8.1f} x "
                     f"{r['total_ms'] / per:9.3f} ms total "
                     f"{r['self_ms'] / per:9.3f} ms self"
                     for name, r in rows)


class Window:
    """Profiles items ``first`` .. ``last`` (1-based) of a loop, maps or
    steps, with torch.profiler (the host, and the card with ``cuda``) and a
    recording, for the CLIs' ``--trace PATH``: the Chrome trace, which
    holds the spans, goes to ``path`` and :func:`format_summary` of the
    same items to ``log``. Call ``before(i)`` and ``after(i)`` around item
    ``i`` and ``close()`` after the loop (a loop shorter than ``last``
    ends the window there; one shorter than ``first`` writes nothing and
    says so). With ``path`` None it does nothing."""

    def __init__(self, path: str | None, *, cuda: bool, log,
                 first: int = 2, last: int = 11):
        self.path, self.cuda, self.log = path, cuda, log
        self.first, self.last = first, last
        self._stack = self._spans = None
        self._items = 0

    def before(self, item: int) -> None:
        if self.path is None or item != self.first:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        if self.cuda:
            torch.cuda.synchronize()
        self._stack = contextlib.ExitStack()
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._spans = self._stack.enter_context(recording())

    def after(self, item: int) -> None:
        if self._stack is not None:
            self._items += 1
            if item == self.last:
                self.close()

    def close(self) -> None:
        if self._stack is None:
            if self.path is not None and self._items == 0:
                self.log(f"no item {self.first}: no trace written to "
                         f"{self.path}")
                self.path = None
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._stack.close()
        self._stack = None
        self._prof.export_chrome_trace(self.path)
        self.log(f"trace of items {self.first}-"
                 f"{self.first + self._items - 1} written to {self.path}; "
                 f"spans per item (count, host ms):\n"
                 + format_summary(self._spans, max(self._items, 1)))


# ------------------------------------------------------------ trace reading

@dataclass
class Trace:
    """What a torch.profiler Chrome trace holds of the program's spans, in
    the trace's us."""
    spans: list      # (name, start, end, tid), ``mdf/`` stripped
    ops: list        # (name, start, dur, spans open at its launch)
    waits: list      # (name, start, dur, tid, spans open at the call)


def read_trace(path: str) -> Trace:
    """The program's spans in a Chrome trace, each device operation (kernel,
    copy, set) with the names of the spans open on its launching thread at
    its launch (outermost first), and the blocking runtime calls
    (:data:`WAITS`) with the spans open at them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, launches, device, waits = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in ("user_annotation", "cpu_op") and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], start, start + dur, e["tid"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (start, e["tid"])
            if name in WAITS:
                waits.append((name, start, dur, e["tid"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((name, start, dur,
                           e.get("args", {}).get("correlation")))
    device.sort(key=lambda d: d[1])
    waits.sort(key=lambda w: w[1])
    queries = [launches.get(corr, (None, None)) for *_, corr in device]
    queries += [(start, tid) for _, start, _, tid in waits]
    open_at = open_spans(spans, queries)
    return Trace(spans=sorted(spans, key=lambda s: s[1]),
                 ops=[(name, start, dur, names) for (name, start, dur, _), names
                      in zip(device, open_at)],
                 waits=[w + (names,) for w, names
                        in zip(waits, open_at[len(device):])])


def open_spans(spans, queries) -> list:
    """For each query (time, thread), the names of the spans open on that
    thread at that time, outermost first; () for a query (None, None)."""
    events = [(tid, start, 0, start - end, name, end)
              for name, start, end, tid in spans]
    events += [(tid, t, 1, i, None, t) for i, (t, tid) in enumerate(queries)
               if t is not None]
    events.sort(key=lambda ev: (str(ev[0]),) + ev[1:4])
    out, stack, current = [()] * len(queries), [], None
    for tid, t, kind, key, name, end in events:
        if tid != current:
            stack, current = [], tid
        if kind == 0:     # a span starts: the spans that ended go
            while stack and stack[-1][1] <= t:
                stack.pop()
            stack.append((name, end))
        else:
            while stack and stack[-1][1] < t:
                stack.pop()
            out[key] = tuple(n for n, _ in stack)
    return out
