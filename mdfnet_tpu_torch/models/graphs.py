"""The eval forward replayed as CUDA graphs, one graph per segment.

On the card the host takes several times longer to enqueue an eval forward
(CoreNet's Python, the kernels' wrappers, ~730 launches) than the card takes
to run it. So at fixed shapes the forward is captured once into CUDA graphs
and replayed. ``CoreNet._eval_segments`` is written once against a runner
and cut into segments:

- a module segment: one call of a top-level child (``Backbone``,
  ``Homoaggre[s]``, ``Regular[s]``, ``Refine``), captured from the module's
  own ``forward`` and replayed inside ``module(...)``, so that the module's
  forward pre-hooks and hooks still run around each replay with that map's
  tensors;
- a glue segment: the ATen work between two module calls (projections and
  hypotheses, a cast, a regression, the confidence), outside every module.

All segments of one key share one memory pool and are captured in the
order they run, so their intermediates reuse memory as the eager forward's
do. The eager runner, :data:`EAGER`, calls each segment as it comes.

When graphs run (:func:`eager_reason` is None): the eval forward on CUDA
tensors with ``plain=False`` outside a spatial-sharding (halo) context. The
training forward, the CPU, ``plain=True`` and spatial sharding stay eager.
Per key (the inputs' shapes and dtypes, the device, and each parameter's
and buffer's storage and version) the first call runs eager, which builds
the kernels and their plans, the second captures and replays, later calls
replay. A weight replaced or written in place is a new key: the graphs
replay what was computed from the weights outside them (the backbone's
composed top-down weights) as it was at capture. At most ``MAX_KEYS`` keys
are kept, the least recently used dropped first.

Under replay:

- the returned ``depth`` and ``confidence`` are fresh tensors;
- the tensors a module's hooks see are the graphs' own buffers. They hold
  this map's values until the next call of the same key, except the cost
  volumes (an aggregate's output, a U-Net's input), whose memory the later
  stages reuse as the eager forward frees it: a hook that keeps one past
  its own call must copy it. Those views do not own their memory, so once
  their key is dropped (past ``MAX_KEYS``) or the model freed they point
  at freed memory. A hook that returns a replacement for the module's
  inputs or output raises, as the graphs read the module's own;
- only the segments' own hooks run: a forward hook or pre-hook on a
  module below a segment (a conv inside a U-Net), or a global one
  (``register_module_forward_hook``), would never fire, so while one is
  registered the forward runs eager (``GRAPHS["eager"]["hooks"]``);
- what the graphs replay is what ran at capture: a function patched in
  afterwards (a kernel's launch wrapper, a submodule's ``forward`` set as
  an attribute) is not called. Patch before a key's first call, or use a
  copy of the model (``copy.deepcopy`` starts with no graphs);
- one forward runs at a time per model, on the calling thread's current
  stream; a call from another stream waits for the previous call.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch
from torch import nn
from torch.nn.modules import module as nn_module

from mdfnet_tpu_torch.parallel import halo
from mdfnet_tpu_torch.utils import tracing

MAX_KEYS = 4
_NOTHING = contextlib.nullcontext()
_MISSING = object()


def eager_reason(imgs: torch.Tensor, plain: bool, train: bool) -> str | None:
    """Why a forward runs eager (a ``tracing.GRAPHS["eager"]`` key), or
    None where its eval path replays graphs."""
    if train:
        return "train"
    if not imgs.is_cuda:
        return "cpu"
    if plain:
        return "plain"
    if halo.current_ctx() is not None:
        return "halo"
    return None


class _Eager:
    """The runner of the eager forward: each segment runs as it comes."""

    def module(self, name, module, *args, **kwargs):
        return module(*args, **kwargs)

    def glue(self, name):
        return _NOTHING

    def transient(self, *tensors) -> None:
        pass


EAGER = _Eager()


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A tensor over ``t``'s memory that does not keep it allocated.

    It keeps the pool of a DTU map's graphs 116 MiB smaller (the cost
    volumes' memory goes back to the later stages). It rests on a private
    torch function, checked on torch 2.11.0+cu128; without it the steps
    would own their arguments."""
    st = t.untyped_storage()
    storage = torch._C._construct_storage_from_data_pointer(
        st.data_ptr(), t.device, st.nbytes())
    return t.new_empty(0).set_(storage, t.storage_offset(), t.shape,
                               t.stride())


class _GlueStep:
    def __init__(self, name: str, graph):
        self.span, self.graph = "graph/" + name, graph

    def __call__(self) -> None:
        with tracing.span(self.span):
            self.graph.replay()


class _ModuleStep:
    """A module segment: ``module(*args, **kwargs)`` with the module's
    ``forward`` swapped for the graph's replay while it runs."""

    def __init__(self, name: str, graph, module, args, kwargs, out):
        self.span, self.graph = "graph/" + name, graph
        self.module, self.args, self.kwargs, self.out = (module, args, kwargs,
                                                         out)

    def __call__(self) -> None:
        attrs = self.module.__dict__
        own = attrs.get("forward", _MISSING)
        attrs["forward"] = self._replay
        try:
            out = self.module(*self.args, **self.kwargs)
        finally:
            if own is _MISSING:
                del attrs["forward"]
            else:
                attrs["forward"] = own
        if out is not self.out:
            raise RuntimeError(f"a forward hook of "
                               f"{type(self.module).__name__} replaced its "
                               "output: the replayed graphs read the "
                               "module's own")

    def _replay(self, *args, **kwargs):
        if len(args) != len(self.args) or any(
                a is not b for a, b in zip(args, self.args)):
            raise RuntimeError(f"a forward pre-hook of "
                               f"{type(self.module).__name__} replaced its "
                               "inputs: the replayed graphs read the "
                               "module's own")
        with tracing.span(self.span):
            self.graph.replay()
        return self.out

    def release(self, ids: set) -> None:
        """Hold the tensors in ``ids`` (by ``id``) as aliases that do not
        keep their memory allocated."""
        def soft(t):
            return _alias(t) if id(t) in ids else t
        self.args = tuple(soft(a) for a in self.args)
        if isinstance(self.out, torch.Tensor):
            self.out = soft(self.out)


class _Capture:
    """The runner that captures each segment into a graph of the shared
    pool, on the current (side) stream; nothing runs on the card."""

    def __init__(self, pool):
        self.pool, self.steps = pool, []

    @contextlib.contextmanager
    def _graph(self):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            yield graph
        finally:
            graph.capture_end()

    def module(self, name, module, *args, **kwargs):
        with self._graph() as graph:
            out = module.forward(*args, **kwargs)
        self.steps.append(_ModuleStep(name, graph, module, args, kwargs, out))
        return out

    @contextlib.contextmanager
    def glue(self, name):
        with self._graph() as graph:
            yield
        self.steps.append(_GlueStep(name, graph))

    def transient(self, *tensors) -> None:
        """The steps stop keeping ``tensors`` allocated: later segments may
        reuse their memory once the forward drops them, as eager does."""
        ids = {id(t) for t in tensors}
        for step in self.steps:
            if isinstance(step, _ModuleStep):
                step.release(ids)


class _Graphs:
    """One key's graphs: the static inputs, the steps in run order, the
    outputs, and the bytes the capture reserved."""

    def __init__(self, model, sources):
        device = sources[0][0].device        # the images
        reserved = torch.cuda.memory_reserved(device)
        self.statics = [None if s is None else torch.empty(
            s.shape, dtype=dtype or s.dtype, device=device)
            for s, dtype in sources]
        capture = _Capture(torch.cuda.graph_pool_handle())
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.outputs = model._eval_segments(capture, *self.statics,
                                                plain=False)
        current.wait_stream(side)
        self.steps = capture.steps
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        tracing.GRAPHS["pool_bytes"] += self.pool_bytes

    def __del__(self, counts=tracing.GRAPHS):   # bound: also at exit
        counts["pool_bytes"] -= getattr(self, "pool_bytes", 0)

    def replay(self, sources) -> dict:
        for static, (source, _) in zip(self.statics, sources):
            if static is not None:
                static.copy_(source)
        for step in self.steps:
            step()
        depth, confidence = self.outputs
        return {"depth": depth.clone(), "confidence": confidence.clone(),
                "coverage_ok": torch.ones((), dtype=torch.bool,
                                          device=depth.device)}


class EvalGraphs:
    """A model's eval forward graphs by key (see the module's docstring)."""

    def __init__(self):
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._tree: list = []
        self._slots: list = []
        self._hooks: list = []
        self._stream = None

    def __deepcopy__(self, memo):       # a copy of the model starts empty
        return EvalGraphs()

    def __reduce__(self):
        return EvalGraphs, ()

    def forward(self, model, imgs, extrinsics, intrinsics, depth_range
                ) -> dict:
        sources = model._eval_inputs(imgs, extrinsics, intrinsics,
                                     depth_range)
        with self._lock:
            weights = self._weights(model)
            if self._hooked():
                tracing.GRAPHS["eager"]["hooks"] += 1
                return model._eval_forward(imgs, extrinsics, intrinsics,
                                           depth_range, plain=False)
            key = (tuple(None if s is None else (s.shape, s.dtype, dtype)
                         for s, dtype in sources), imgs.device, weights)
            entry = self._entries.get(key, _MISSING)
            if entry is _MISSING:
                self._keep(key, None)
                tracing.GRAPHS["eager"]["first_call"] += 1
                return model._eval_forward(imgs, extrinsics, intrinsics,
                                           depth_range, plain=False)
            with torch.cuda.device(imgs.device):
                stream = torch.cuda.current_stream()
                if self._stream is not None and self._stream != stream:
                    stream.wait_stream(self._stream)
                self._stream = stream
                if entry is None:
                    entry = self._entries[key] = _Graphs(model, sources)
                    tracing.GRAPHS["captures"] += 1
                self._entries.move_to_end(key)
                tracing.GRAPHS["replays"] += 1
                return entry.replay(sources)

    def _keep(self, key, entry) -> None:
        self._entries[key] = entry
        while len(self._entries) > MAX_KEYS:
            self._entries.popitem(last=False)

    def _weights(self, model) -> tuple:
        """Each parameter's and buffer's storage and version; the slots
        they sit in, and the hooks of the modules below the segments, are
        found again when a submodule was replaced."""
        if not self._tree or any(d.get(n) is not c for d, n, c in self._tree):
            mods = list(model.modules())
            self._tree = [(m._modules, n, c) for m in mods
                          for n, c in m._modules.items()]
            self._slots = [(d, n) for m in mods
                           for d in (m._parameters, m._buffers) for n in d]
            segments = [m for c in model.children() for m in (
                c if isinstance(c, nn.ModuleList) else (c,))]
            self._hooks = [d for seg in segments for m in seg.modules()
                           if m is not seg
                           for d in (m._forward_pre_hooks, m._forward_hooks)]
        ts = [t for d, n in self._slots if (t := d.get(n)) is not None]
        return tuple([t.data_ptr() for t in ts] + [t._version for t in ts])

    def _hooked(self) -> bool:
        """Whether a forward hook would not fire under replay: one on a
        module below a segment, or a global one (after ``_weights``)."""
        return bool(nn_module._global_forward_pre_hooks
                    or nn_module._global_forward_hooks or any(self._hooks))
