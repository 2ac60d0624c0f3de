"""A second architecture enters the benchmark as new files and new entries
alone: in a copy of the benchmark, a toy model (a dilated convolution with
BatchNorm, then a 2-D transposed convolution) brings its reference, its
architecture module, its configuration and its cell's limits, and a whole
eval run of its cell goes through the harness, the generic work count and
its stage hooks, with no file of the copy changed but ``BENCHMARK.json``,
which gains entries only. The port has no toy model, so the run puts the
control (the reference) in the program's place."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TOY_REFERENCE = '''"""A toy reference: a dilated convolution with BatchNorm at
half size on the reference view, then a transposed convolution back to full
size."""
from __future__ import annotations

import contextlib

import torch
from torch import nn


class Toy(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.Features = nn.Sequential(
            nn.Conv2d(3, c, 3, 2, padding=2, dilation=2, bias=False),
            nn.BatchNorm2d(c), nn.ReLU())
        self.Head = nn.ConvTranspose2d(c, 2, 3, 2, padding=1,
                                       output_padding=1)
        self.operand = None

    def set_operand_dtype(self, dtype):
        self.operand = dtype

    def forward(self, imgs, extrinsics, intrinsics, depth_range,
                plain=False, train=False):
        with torch.set_grad_enabled(train):
            x = imgs[:, 0].float().permute(0, 3, 1, 2)
            out = torch.sigmoid(self.Head(self.Features(x)))
            lo = depth_range[:, :1, None].float()
            hi = depth_range[:, 1:, None].float()
            depth = lo + (hi - lo) * out[:, 0]
            if train:
                return {"depth": [depth]}
            return {"depth": depth, "confidence": out[:, 1],
                    "stage_depths": [out[:, 0]]}


@contextlib.contextmanager
def exact_f32():
    yield
'''

TOY_ARCH = '''"""The toy's layers, work and stage hooks."""
from __future__ import annotations

from portbench.reference import toy as ref

LAYERS = ("Features", "Head")


def build(cfg):
    return ref.Toy(cfg["model"]["channels"])


def layer_work(cfg, shapes, macs, params):
    pixels = shapes["batch"] * shapes["height"] * shapes["width"]
    c = cfg["model"]["channels"]
    return {"Features": {"macs": macs["Features"], "flops_f32": 0,
                         "bytes": 2 * pixels * (3 + c // 4)},
            "Head": {"macs": macs["Head"], "flops_f32": 0,
                     "bytes": 2 * pixels * (c // 4 + 2)}}


def stages(cfg):
    return 1


class Stages:
    def __init__(self, model, n):
        self.outs = []
        self.handles = [model.Head.register_forward_hook(
            lambda _m, _a, o: self.outs.append(o))]

    def close(self):
        for handle in self.handles:
            handle.remove()
        return [self.outs[-1][:, 0].sigmoid().float().cpu()]


def stage_hooks(model, n):
    return Stages(model, n)
'''

TOY_CONFIG = {"source": "a toy for the benchmark's tests", "reference": "toy",
              "model": {"channels": 4}, "compute_dtype": "bfloat16",
              "eval": {"height": 64, "width": 96, "views": 3, "batch": 1},
              "train": {"height": 64, "width": 96, "views": 3, "batch": 2,
                        "lr": 0.001},
              "reduced": []}

RUN = '''
import json, sys, time
from pathlib import Path
root = Path.cwd()
sys.path.insert(0, str(root))
import torch
from portbench import archs
from portbench.lib import count, harness, report
torch.set_num_threads(2)
torch.cuda.get_device_name = lambda *_: "cpu"
cell = harness.load_cell("toy.eval", root)
cfg = cell["cfg"]
assert Path(harness.reference_module(cfg).__file__).parent.parent.parent \\
    == root
arch = archs.of(cfg)
res = harness.run_cell(cell, 2 ** 31 + 5, 0.1, True, "cpu",
                       time.perf_counter(), control=True, min_items=24)
line = report.result_line(cell, res, True)
# the stage hooks on the reference that make_state and build_reference give
loop = harness.loop_module("eval", root).Loop(harness.Run(cell, 3, "cpu"))
state = harness.make_state(cfg, cell["mix"], 3, "cpu", loop.item(0))
model = harness.build_reference(cfg, state, "cpu")
hooks = arch.stage_hooks(model, arch.stages(cfg))
out = model(*[loop.item(1)[k] for k in harness.INPUTS])
stage = hooks.close()
# the work count against the products of the toy's own convolutions
work = count.forward_work(cfg, cfg["eval"], train=False)
with torch.no_grad():
    feats = torch.nn.functional.conv2d(torch.ones(1, 3, 64, 96),
                                       torch.ones(4, 3, 3, 3), stride=2,
                                       padding=2, dilation=2)
    head = torch.nn.functional.conv_transpose2d(
        torch.ones(feats.shape), torch.ones(4, 2, 3, 3), stride=2,
        padding=1, output_padding=1)
print("RESULT", json.dumps({
    "correct": line["correct"], "checks": line["checks"],
    "labels": list(res["labels"]), "spans": sorted(res["trace"].spans),
    "breakdown": sorted(line["breakdown"]), "metrics": sorted(line["metrics"]),
    "stage_equal": bool(torch.allclose(stage[0], out["stage_depths"][0],
                                       rtol=0, atol=1e-6)),
    "work": work, "feats_macs": int(feats.sum()),
    "head_macs": int(head.sum())}))
'''


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_second_architecture_plugs_in_as_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(tmp_path)
    bench = tmp_path / "portbench"
    for rel, text in (("reference/toy.py", TOY_REFERENCE),
                      ("archs/toy.py", TOY_ARCH),
                      ("configs/toy.json", json.dumps(TOY_CONFIG)),
                      ("limits/toy.eval.json",
                       json.dumps({"depth": 1e-4, "depth_p90": 1e-4}))):
        assert not (bench / rel).exists()
        (bench / rel).write_text(text)
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "toy", "source": "a toy",
                            "file": "portbench/configs/toy.json",
                            "reduced": [], "why": "the plug-in test"})
    data["workloads"].append({"name": "toy.eval", "config": "toy",
                              "traffic": "eval", "chips": 1,
                              "why": "the plug-in test"})
    for section, name in (("end_to_end", "maps_per_s"),
                          ("per_layer", "idle_pct.eval"),
                          ("per_layer", "enqueue_ms.eval")):
        entry = next(m for m in data[section] if m["name"] == name)
        entry["workloads"].append("toy.eval")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data, indent=1))

    res = subprocess.run([sys.executable, "-c", RUN], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    got = json.loads(res.stdout.split("RESULT ", 1)[1])

    assert got["correct"], got["checks"]
    assert got["labels"] == ["input copy", "model call", "output copy",
                             "Features", "Head"]
    assert {"model call", "Features", "Head"} <= set(got["spans"])
    assert got["breakdown"] == ["device_ops", "idle_gaps"]
    assert got["metrics"], "no per-layer metric read"
    assert got["stage_equal"]
    assert list(got["work"]) == ["Features", "Head"]
    assert got["work"]["Features"]["macs"] == got["feats_macs"]
    assert got["work"]["Head"]["macs"] == got["head_macs"]
    assert got["work"]["Features"]["params"] == 4 * 3 * 9 + 2 * 4
    assert got["work"]["Head"]["params"] == 4 * 2 * 9 + 2

    after = _files(tmp_path)
    assert {k: after[k] for k in before} == before
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert new["configs"][:-1] == old["configs"]
    assert new["workloads"][:-1] == old["workloads"]
    for section in ("end_to_end", "per_layer"):
        for a, b in zip(old[section], new[section]):
            a_cells, b_cells = a.get("workloads"), b.get("workloads")
            assert {**b, "workloads": a_cells} == {**a, "workloads": a_cells}
            assert b_cells == a_cells or b_cells == a_cells + ["toy.eval"]
