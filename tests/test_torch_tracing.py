"""The port's spans (``mdfnet_tpu_torch/utils/tracing.py``): off by default
and shared, recorded as a tree per thread, mirrored into torch.profiler's
Chrome trace on its clock, and read back from such a trace.

The last test is marked ``cuda`` and skips without a card: each
``kernel/*`` span is one step of the launch counters, and every
hand-written kernel in a profiled forward was launched inside one. On a
GPU machine:

    python -m pytest tests/test_torch_tracing.py -q -m cuda --noconftest
"""
import collections
import json
import re
import statistics
import sys
import threading

import pytest
import torch

from mdfnet_tpu_torch.data import make_batch, make_plane_scene
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.train_lib import (batch_to_device, make_optimizer,
                                        train_step)
from mdfnet_tpu_torch.utils import tracing

INPUTS = ("imgs", "extrinsics", "intrinsics", "depth_range")
STAGE_CHILDREN = ["hypotheses", "aggregate", "regular", "regress"]


def _eval_args(device="cpu", height=64, width=96, nviews=3):
    batch = make_batch(make_plane_scene(height=height, width=width,
                                        nviews=nviews), batch=1)
    return [torch.from_numpy(batch[k]).to(device) for k in INPUTS]


@pytest.fixture(scope="module")
def eval_model():
    model = build_model(seed=0, device="cpu")
    args = _eval_args()
    model(*args)
    return model, args


def _children(spans, index):
    return [s.name for s in spans if s.parent == index]


def test_span_off_is_one_shared_noop(eval_model, monkeypatch):
    """Off, every span is the same object and no span object is built,
    through a whole eval forward."""
    built = []

    class Counting(tracing._On):
        def __init__(self, name):
            built.append(name)
            super().__init__(name)
    monkeypatch.setattr(tracing, "_On", Counting)
    assert tracing.span("prep") is tracing.span("forward")
    with tracing.span("prep") as s:
        assert s is tracing.span("x")
    model, args = eval_model
    model(*args)
    assert built == [] and tracing._recorder is None


def test_recorded_eval_forward_is_the_layer_tree(eval_model):
    model, args = eval_model
    with tracing.recording() as spans:
        model(*args)
    assert all(isinstance(s, tracing.Span) and s.end_ns >= s.start_ns
               for s in spans)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["forward"]
    top = [n for n in _children(spans, roots[0]) if n != "prep"]
    nstages = len(model.ndepths)
    assert top == ["backbone"] + ["stage"] * nstages + ["refine",
                                                        "confidence"]
    for i, s in enumerate(spans):
        if s.name == "stage":
            assert [n for n in _children(spans, i)
                    if n != "prep"] == STAGE_CHILDREN
        if s.parent >= 0:           # a child lies inside its parent
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # every conv and fold of the forward is prep on the CPU: no kernels
    names = collections.Counter(s.name for s in spans)
    assert names["prep"] > 20 and not any(n.startswith("kernel/")
                                          for n in names)
    # self times partition the one root's time
    rows = tracing.summary(spans)
    assert sum(r["self_ms"] for r in rows.values()) == pytest.approx(
        rows["forward"]["total_ms"], rel=1e-9)
    assert all(r["self_ms"] >= 0 for r in rows.values())


def test_recorded_train_step_is_the_step_tree():
    model = build_model(seed=0, device="cpu").requires_grad_(True)
    opt = make_optimizer(model, 1e-3)
    batch = batch_to_device(make_batch(make_plane_scene(
        height=32, width=64, nviews=3), batch=2), "cpu")
    with tracing.recording() as spans:
        train_step(model, opt, batch)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["train_step"]
    assert [n for n in _children(spans, roots[0]) if n != "prep"] == [
        "forward", "loss", "backward", "optimizer"]
    vjps = collections.Counter(s.name for s in spans
                               if s.name.startswith("vjp/"))
    assert set(vjps) == {"vjp/conv3d", "vjp/trconv3d", "vjp/conv2d",
                         "vjp/sample"}
    for s in spans:
        if s.name.startswith("vjp/"):
            # the parent chain lies on the thread that ran the backward
            # (the caller's on the CPU, where it ends in "backward")
            chain, p = [], s.parent
            while p >= 0:
                assert spans[p].tid == s.tid
                chain.append(spans[p].name)
                p = spans[p].parent
            assert chain == ["backward", "train_step"]


def test_summary_counts_total_and_self():
    S = tracing.Span
    spans = [S("forward", -1, 1, 0, 10_000_000),
             S("prep", 0, 1, 1_000_000, 2_000_000),
             S("kernel/conv_tc", 0, 1, 3_000_000, 7_000_000),
             S("prep", 2, 1, 3_500_000, 4_000_000),
             S("vjp/conv3d", -1, 2, 0, 3_000_000)]
    rows = tracing.summary(spans)
    assert rows["forward"] == {"count": 1, "total_ms": 10.0, "self_ms": 5.0}
    assert rows["prep"] == {"count": 2, "total_ms": 1.5, "self_ms": 1.5}
    assert rows["kernel/conv_tc"] == {"count": 1, "total_ms": 4.0,
                                      "self_ms": 3.5}
    assert rows["vjp/conv3d"]["self_ms"] == 3.0
    text = tracing.format_summary(spans, per=2)
    assert text.splitlines()[0].split()[:4] == ["forward", "0.5", "x",
                                                "5.000"]


def test_profiler_mirror_shares_the_clock(eval_model, tmp_path):
    """Under a CPU torch.profiler each span is an ``mdf/`` annotation of
    the Chrome trace, and its start agrees with the recording's within
    100 us on the trace's clock (``offset_ns``, the trace's base). The two
    readings are taken one after the other, so a host that preempts the
    thread between them parts a few: the median is far inside, and nine
    spans in ten are within."""
    from torch.profiler import ProfilerActivity, profile
    model, args = eval_model
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.recording() as spans:
        model(*args)
    prof.export_chrome_trace(path)
    with open(path) as f:
        base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))
    read = tracing.read_trace(path)
    assert collections.Counter(s[0] for s in read.spans) == \
        collections.Counter(s.name for s in spans)
    theirs, ours = (collections.defaultdict(list) for _ in range(2))
    for name, start, _, _ in read.spans:
        theirs[name].append(start * 1e3 + base_ns)
    for s in spans:
        ours[s.name].append(s.start_ns + spans.offset_ns)
    gaps = [abs(a - b) for name in ours
            for a, b in zip(sorted(theirs[name]), sorted(ours[name]))]
    assert statistics.median(gaps) < 100e3, statistics.median(gaps)
    assert sum(g < 100e3 for g in gaps) >= 0.9 * len(gaps), gaps
    assert read.ops == [] and read.waits == []      # no card


def test_recording_is_thread_safe():
    """More threads than cores open nested spans at once, switching as
    often as the interpreter allows: each span's parent is the enclosing
    span of its own thread, and none is lost."""
    n, reps = 16, 200
    go = threading.Barrier(n)

    def work(tag):
        go.wait()
        for _ in range(reps):
            with tracing.span(f"outer{tag}"):
                with tracing.span(f"inner{tag}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as spans:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    counts = collections.Counter(s.name for s in spans)
    assert counts == {f"{kind}{t}": reps for t in range(n)
                      for kind in ("outer", "inner")}
    for s in spans:
        if s.name.startswith("inner"):
            parent = spans[s.parent]
            assert parent.name == "outer" + s.name[len("inner"):]
            assert parent.tid == s.tid
        else:
            assert s.parent == -1
    assert len({s.tid for s in spans}) == n


def test_a_span_open_when_the_recording_ends_keeps_end_0():
    """A span another thread still holds when the recording stops stays in
    it with end_ns 0, and its close later raises nothing."""
    opened, release = threading.Event(), threading.Event()

    def hold():
        with tracing.span("long"):
            opened.set()
            release.wait(timeout=60)

    worker = threading.Thread(target=hold)
    with tracing.recording() as spans:
        worker.start()
        assert opened.wait(timeout=60)
    release.set()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert [(s.name, s.end_ns) for s in spans] == [("long", 0)]


def test_read_trace_attributes_launches_and_waits(tmp_path):
    """Device operations go to the spans open on their launching thread at
    the launch, blocking calls to the spans open at them; siblings back to
    back and a span on another thread do not leak."""
    def x(cat, name, ts, dur, tid, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "pid": 1, "args": args}
    events = [
        x("user_annotation", "mdf/forward", 0, 100, 7),
        x("user_annotation", "mdf/prep", 10, 10, 7),
        x("user_annotation", "mdf/kernel/conv_tc", 20, 10, 7),
        x("user_annotation", "mdf/prep", 21, 3, 7),
        x("user_annotation", "mdf/vjp/conv3d", 15, 30, 9),
        x("user_annotation", "other/window", 0, 200, 7),
        x("cuda_runtime", "cudaLaunchKernel", 12, 1, 7, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 22, 1, 7, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 28, 1, 7, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 16, 1, 9, correlation=4),
        x("cuda_runtime", "cudaMemcpyAsync", 150, 1, 7, correlation=5),
        x("cuda_runtime", "cudaStreamSynchronize", 60, 5, 7),
        x("cuda_runtime", "cudaStreamSynchronize", 120, 5, 7),
        x("kernel", "elementwise_kernel", 40, 2, 0, correlation=1),
        x("kernel", "conv_tc_kernel<16>", 42, 2, 0, correlation=3),
        x("kernel", "elementwise_kernel", 41, 1, 0, correlation=2),
        x("kernel", "splat_reduce_kernel", 50, 1, 0, correlation=4),
        x("gpu_memcpy", "Memcpy DtoH", 160, 4, 0, correlation=5),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    read = tracing.read_trace(str(path))
    assert [s[0] for s in read.spans] == [
        "forward", "prep", "vjp/conv3d", "kernel/conv_tc", "prep"]
    assert [(o[0], o[3]) for o in read.ops] == [
        ("elementwise_kernel", ("forward", "prep")),
        ("elementwise_kernel", ("forward", "kernel/conv_tc", "prep")),
        ("conv_tc_kernel<16>", ("forward", "kernel/conv_tc")),
        ("splat_reduce_kernel", ("vjp/conv3d",)),
        ("Memcpy DtoH", ())]
    assert [(w[1], w[4]) for w in read.waits] == [(60, ("forward",)),
                                                  (120, ())]


def test_window_profiles_the_items_it_names(tmp_path):
    """The CLIs' ``--trace``: items 2-3 of 4 profiled and recorded, their
    trace written and their spans logged."""
    logs, path = [], str(tmp_path / "w.json")
    window = tracing.Window(path, cuda=False, log=logs.append, first=2,
                            last=3)
    for item in range(1, 5):
        window.before(item)
        with tracing.span(f"item{item}"):
            torch.ones(8).sum()
        window.after(item)
    window.close()
    names = [s[0] for s in tracing.read_trace(path).spans]
    assert names == ["item2", "item3"]
    assert len(logs) == 1 and "items 2-3" in logs[0]
    assert re.search(r"item2 +0\.5 x", logs[0])   # once in two items
    quiet = tracing.Window(None, cuda=False, log=logs.append)
    quiet.before(2)
    quiet.after(11)
    quiet.close()
    assert len(logs) == 1
    short = tracing.Window(str(tmp_path / "none.json"), cuda=False,
                           log=logs.append)
    short.before(1)
    short.after(1)
    short.close()
    short.close()
    assert len(logs) == 2 and "no item 2" in logs[1]
    assert not (tmp_path / "none.json").exists()


def test_eval_cli_trace_writes_maps_2_on(tmp_path, caplog):
    """``cli.eval --trace`` on the CPU: maps 2-3 of 3 profiled, their trace
    holds a forward each, and the log their spans; not with --spatial."""
    from mdfnet_tpu_torch.cli.eval import main as eval_main
    from mdfnet_tpu_torch.data import write_dtu_eval_tree
    from mdfnet_tpu_torch.utils.weights import save_checkpoint
    data = tmp_path / "data"
    write_dtu_eval_tree(str(data / "dtu1600x1200"), scans=(9,), nviews=3,
                        height=64, width=96)
    ckpt = str(tmp_path / "model.pth")
    save_checkpoint(build_model(seed=0, device="cpu"), ckpt)
    path = str(tmp_path / "trace.json")
    common = ["-p", ckpt, "--root", str(data), "--scans", "9", "-o",
              str(tmp_path / "out"), "--device", "cpu", "--trace", path]
    with caplog.at_level("INFO"):
        stats = eval_main(common)
    assert stats["n_views"] == 2
    names = collections.Counter(s[0] for s in tracing.read_trace(path).spans)
    assert names["forward"] == 2 and names["stage"] == 6
    assert any("trace of items 2-3" in r.message for r in caplog.records)
    with pytest.raises(SystemExit):
        eval_main(common + ["--spatial", "2"])


def test_train_cli_trace_writes_steps_2_on(tmp_path, caplog):
    """``train --trace`` on the CPU: 2 epochs of 2 steps, steps 2-4 in the
    trace, each a train_step with its backward."""
    from mdfnet_tpu_torch.data import write_dtu_train_tree
    from mdfnet_tpu_torch.train import main as train_main
    write_dtu_train_tree(str(tmp_path / "dtu640x512"), scans=(1,), nviews=4,
                         lightings=1, height=32, width=64)
    path = str(tmp_path / "trace.json")
    with caplog.at_level("INFO"):
        train_main(["-d", "dtu", "--root", str(tmp_path), "--scans", "1",
                    "--lightings", "1", "--epochs", "2", "--batch-size", "2",
                    "--nviews", "3", "--ckpt-dir", str(tmp_path / "pth"),
                    "--device", "cpu", "--trace", path])
    names = collections.Counter(s[0] for s in tracing.read_trace(path).spans)
    assert names["train_step"] == names["backward"] == 3
    assert names["vjp/conv3d"] > 0
    assert any("trace of items 2-4" in r.message for r in caplog.records)


# the launch counters' keys that each kernel/<entry> span steps
_SPAN_COUNTERS = {
    "conv_tc": ("conv", "conv_tc"), "trconv_tc": ("conv", "conv_tc"),
    "conv_co1": ("conv", "conv_co1"), "conv_stream": ("conv", "conv_stream"),
    "conv_chain": ("conv", "conv2d_chain"),
    "conv3d_pair": ("conv", "conv3d_pair_bn_act"),
    "conv3d_pair_tc": ("conv", "conv3d_pair_bn_act"),
    "rowsweep_aggregate": ("aggregate", "rowsweep_aggregate"),
    "rowsweep_aggregate_train": ("aggregate",
                                 "rowsweep_aggregate_with_wsum"),
    "rowsweep_stats": ("aggregate", "rowsweep_stats"),
    "sample_2d": ("warp", "sample_2d"), "splat_2d": ("splat", "splat_2d")}
# the hand-written kernels' device names (ops/cuda/csrc/*.cu)
_HAND_WRITTEN = re.compile(
    r"\b(conv3d_pair(_tc)?|conv_bn_act|trconv_bn_act|conv_chain|conv_co1|"
    r"conv_stream|(tr)?conv_tc|rowsweep_aggregate|rowsweep_stats(_final)?|"
    r"sample_2d|splat_\w+)_kernel\b")


@pytest.mark.cuda
def test_kernel_spans_are_the_launch_counters(tmp_path):
    """One DTU-shaped bf16 eval forward: each ``kernel/<entry>`` span count
    is its counter's step, the direct kernels' spans the rest of the conv
    wrappers' launches; every hand-written kernel in the profiled trace was
    launched inside a ``kernel/*`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from torch.profiler import ProfilerActivity, profile
    from mdfnet_tpu_torch.ops.cuda import (aggregate_kernel, conv_kernel,
                                           splat_kernel, warp_kernel)
    counters = {"conv": conv_kernel.LAUNCHES,
                "aggregate": aggregate_kernel.LAUNCHES,
                "warp": warp_kernel.LAUNCHES, "splat": splat_kernel.LAUNCHES}
    model = build_model(compute_dtype="bfloat16", seed=0, device="cuda")
    args = _eval_args("cuda", 1184, 1600, 5)
    model(*args)
    torch.cuda.synchronize()
    # a model's first call of a shape runs eager (its second replays CUDA
    # graphs, launching nothing on the host): the profiled call is a fresh
    # model's first, the kernels already built
    model = build_model(compute_dtype="bfloat16", seed=0, device="cuda")
    before = {k: dict(v) for k, v in counters.items()}
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            tracing.recording() as spans:
        model(*args)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    steps = {(k, c): v - before[k][c] for k, d in counters.items()
             for c, v in d.items()}
    kernels = collections.Counter(s.name[len("kernel/"):] for s in spans
                                  if s.name.startswith("kernel/"))
    direct = ("conv_bn_act", "trconv_bn_act")
    assert set(kernels) <= set(_SPAN_COUNTERS) | set(direct)
    assert sum(kernels.values())
    by_counter = collections.Counter()
    for entry, n in kernels.items():
        if entry not in direct:
            by_counter[_SPAN_COUNTERS[entry]] += n
    for key in set(_SPAN_COUNTERS.values()):
        assert by_counter[key] == steps[key], key
    wrappers = sum(steps["conv", c] for c in ("conv3d_bn_act",
                                               "trconv3d_bn_act",
                                               "conv2d_bn_act"))
    assert sum(kernels[e] for e in direct) == wrappers - (
        steps["conv", "conv_tc"] + steps["conv", "conv_co1"]
        + steps["conv", "conv_stream"])
    read = tracing.read_trace(path)
    hand = [o for o in read.ops if _HAND_WRITTEN.search(o[0])]
    assert len(hand) >= sum(kernels.values())
    for name, _, _, open_spans in hand:
        assert any(s.startswith("kernel/") for s in open_spans), name
