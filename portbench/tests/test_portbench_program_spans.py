"""The program's own spans (``mdf/`` ranges of ``mdfnet_tpu_torch``'s
tracing, which a running profiler records in every traced run) leave the
benchmark's reading of a trace as it was: the same window, operations,
spans, busy time, idle gaps and breakdown as the trace without them."""
import json

import torch

from portbench.lib import trace as tr


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


BENCH = [
    _x("user_annotation", "portbench/window", 0, 400, 1),
    _x("user_annotation", "portbench/model call", 10, 150, 1),
    _x("user_annotation", "portbench/Backbone", 20, 40, 1),
    _x("user_annotation", "portbench/output copy", 170, 30, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 2, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 90, 2, 1, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 2, 9, correlation=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 175, 2, 1, correlation=4),
    _x("cuda_runtime", "cudaStreamSynchronize", 178, 20, 1),
    _x("kernel", "conv_tc_kernel<16>", 60, 30, 0, correlation=1),
    _x("kernel", "elementwise_kernel", 130, 10, 0, correlation=2),
    _x("kernel", "splat_reduce_kernel", 150, 5, 0, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH", 190, 8, 0, correlation=4),
]
PROGRAM = [
    _x("user_annotation", "mdf/forward", 12, 140, 1),
    _x("user_annotation", "mdf/backbone", 21, 38, 1),
    _x("user_annotation", "mdf/kernel/conv_tc", 22, 6, 1),
    _x("user_annotation", "mdf/prep", 23, 1, 1),
    _x("user_annotation", "mdf/vjp/conv3d", 110, 30, 9),
]


def _read(tmp_path, events, name):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return tr.read_trace(str(path))


def test_program_spans_leave_the_reading_unchanged(tmp_path):
    plain = _read(tmp_path, BENCH, "plain.json")
    both = _read(tmp_path, BENCH + PROGRAM, "both.json")
    assert both.window == plain.window
    assert both.ops == plain.ops
    assert both.spans == plain.spans
    assert (both.busy_us, both.gaps) == (plain.busy_us, plain.gaps)
    labels = ("input copy", "model call", "output copy", "Backbone")
    assert tr.breakdown(both, labels) == tr.breakdown(plain, labels)
    assert [(o.spans, o.main) for o in both.ops] == [
        (("window", "model call", "Backbone"), True),
        (("window", "model call"), True), ((), False),
        (("window", "output copy"), True)]


def test_a_profiled_program_forward_keeps_only_the_benchmarks_spans(
        tmp_path):
    """On the CPU: the port's eval forward under the benchmark's profiler
    writes ``mdf/`` ranges into the trace, which the reading leaves out."""
    from mdfnet_tpu_torch.models.registry import build_model
    model = build_model(seed=0, device="cpu")
    args = (torch.rand(1, 3, 64, 96, 3), torch.eye(4).repeat(1, 3, 1, 1),
            torch.tensor([[[115.2, 0, 48], [0, 115.2, 32], [0, 0, 1]]]
                         ).repeat(1, 3, 1, 1), torch.tensor([[425.0, 935.0]]))
    spans = tr.Spans()
    spans.on = True
    path = str(tmp_path / "trace.json")
    with tr.profiled(path, cuda=False), spans("window"):
        with spans("model call"):
            model(*args)
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"}
    assert "mdf/forward" in names and "mdf/stage" in names
    assert set(tr.read_trace(path).spans) == {"window", "model call"}
