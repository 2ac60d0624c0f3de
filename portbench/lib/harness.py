"""One run of one cell: set-up, the measured window, the traced sub-window,
and the comparison with the plain reference that decides ``correct``.

Everything that belongs to a cell is found by name: the configuration's
file (``BENCHMARK.json`` names it), its architecture (the file's
``reference``: ``reference/<reference>.py`` and ``archs/<reference>.py``,
see :mod:`portbench.archs`), the traffic mix's parameters
(``traffic/<mix>.json``), the loop that the mix names (``loops/<loop>.py``:
its ``Loop`` drives the window, plants faults and runs the comparison), the
cell's limits (``limits/<cell>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``). A new mix on an existing loop is a data file
alone; a new loop is a new file.

``setup_s`` runs from the start of the process to the first timed map or
step, less the seconds of the benchmark's own work in it: drawing the
scenes and the reference's forward that calibrates the eval weights.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import archs
from portbench.lib import scenes, trace as tr, weights

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "mdfnet_tpu")
INPUTS = ("imgs", "extrinsics", "intrinsics", "depth_range")
# the nearest precision below the configuration's, for the control
CONTROL_DTYPE = {"bfloat16": torch.float8_e4m3fn}


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------ the cell

def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, mix, limits and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return {"name": name, "cell": cell,
            "cfg": json.loads((root / conf["file"]).read_text()),
            "mix": json.loads((root / "portbench" / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((root / "portbench" / "limits"
                                  / f"{name}.json").read_text()),
            "end_to_end": e2e, "per_layer": per_layer}


def _load(folder: str, name: str, root: Path):
    path = root / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _load("metrics", metric, root).read


def loop_module(name: str, root: Path = ROOT):
    """``loops/<name>.py``: its ``Loop``, the configuration's section it
    reads (``SHAPE``), its span labels and the faults it can plant."""
    return _load("loops", name, root)


def reference_module(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


# ------------------------------------------------------------ set-up

def build_program(cfg: dict, state: dict, device, train: bool):
    """The port's CoreNet through its registry, with the benchmark's
    weights."""
    from mdfnet_tpu_torch.config import ModelConfig
    from mdfnet_tpu_torch.models.registry import build_model
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["model"].items()}
    model = build_model(ModelConfig(**fields),
                        compute_dtype=cfg["compute_dtype"], device=device)
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(train)


def build_reference(cfg: dict, state: dict, device, operand=None):
    model = archs.of(cfg).build(cfg).to(device)
    model.load_state_dict(state, strict=True)
    model.set_operand_dtype(operand)
    return model.eval()


def build_control(cfg: dict, state: dict, device, train: bool):
    """The reference in the program's place, its convolutions' operands in
    the nearest precision below the configuration's."""
    model = build_reference(cfg, state, device,
                            CONTROL_DTYPE[cfg["compute_dtype"]])
    return model.train(train).requires_grad_(train)


def make_state(cfg: dict, mix: dict, seed: int, device, item: dict,
               spent: dict | None = None) -> dict:
    """The weights from the seed; with the mix's ``calibrate_bn``, the
    running statistics from the reference's batch statistics on ``item``
    (the first map or batch), its seconds in ``spent["calibration"]``."""
    with torch.device("meta"):
        shapes = archs.of(cfg).build(cfg)
    w = mix["weights"]
    state = weights.make_state(shapes, 2 * seed, device,
                               sharpen=w["sharpen"])
    if w["calibrate_bn"]:
        t = time.perf_counter()
        model = build_reference(cfg, state, device)
        with reference_module(cfg).exact_f32():
            state = weights.calibrate_bn(
                model, state, [item[k].to(device) for k in INPUTS])
        del model
        sync(device)
        if spent is not None:
            spent["calibration"] = time.perf_counter() - t
    return state


def make_data(shape: dict, mix: dict, n: int, seed: int, device) -> dict:
    """``n`` scenes from the seed, in pinned host memory."""
    v, h, w = shape["views"], shape["height"], shape["width"]
    data = scenes.GENERATORS[mix["generator"]](
        2 * seed + 1, n, v, h, w, focal=mix["focal_per_width"] * w,
        baseline=mix["view_span"] / (v - 1),
        range_follows_depth=mix.get("range_follows_depth", False),
        device=device)
    out = {k: data[k] for k in INPUTS}
    out["ref_depths"] = scenes.pyramid(data["depth"])
    return _to_host(out, pin=torch.device(device).type == "cuda")


def _to_host(tree, pin: bool):
    if isinstance(tree, dict):
        return {k: _to_host(v, pin) for k, v in tree.items()}
    t = tree.cpu()
    return t.pin_memory() if pin else t


def rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device, non_blocking=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """Per leaf, the gap between the norms of ``got`` and ``want`` over the
    larger of ``want``'s norm of that leaf and of the median leaf."""
    norms = {n: float(want[n].float().norm()) for n in names}
    floor = statistics.median(norms.values())
    return {n: abs(float(got[n].float().norm()) - norms[n])
            / max(norms[n], floor) for n in names}


# ------------------------------------------------------------ one run

class Run:
    """What a loop reads of its run: the cell's configuration and mix, the
    seed, the device, the fault planted (or None) and the spans."""

    def __init__(self, cell: dict, seed: int, device, *,
                 fault: str | None = None):
        self.seed, self.device = seed, torch.device(device)
        self.cfg, self.mix = cell["cfg"], cell["mix"]
        self.fault = fault
        self.spans = tr.Spans()


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             t0: float, *, control: bool = False, fault: str | None = None,
             min_items: int = 0) -> dict:
    """Set-up, the window (and, with ``traced`` or where an end-to-end
    metric of the cell reads the device's trace, the profiled sub-window),
    then the comparison. ``control`` puts the control in the program's
    place; ``fault`` plants a fault in the timed path; ``min_items`` runs
    the window on until that many maps or steps (calibration only).
    Returns what the result line is made from; ``res["check"]`` holds
    every number compared."""
    phases = {"imports": time.perf_counter() - t0}
    run = Run(cell, seed, device, fault=fault)
    mod = loop_module(run.mix["loop"])
    if fault not in (None, *mod.FAULTS):
        raise ValueError(f"loop {run.mix['loop']!r} plants no {fault!r}")
    train = mod.SHAPE == "train"
    spent = {}
    t = time.perf_counter()
    loop = mod.Loop(run)
    spent["scenes"] = time.perf_counter() - t
    phases["scenes"] = time.perf_counter() - t0
    state = make_state(run.cfg, run.mix, seed, run.device, loop.item(0),
                       spent)
    build = build_control if control else build_program
    model = loop.attach(build(run.cfg, state, run.device, train))
    phases["weights and model"] = time.perf_counter() - t0
    took = loop.warmup(model)
    sync(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    phases["warm-up"] = time.perf_counter() - t0
    setup_s = phases["warm-up"] - sum(spent.values())
    host = loop.window(model, seconds, min_items)
    sync(run.device)
    peak = (torch.cuda.max_memory_allocated()
            if run.device.type == "cuda" else 0)
    phases["first items"] = took
    phases["left out of setup_s"] = spent
    out = {"setup_s": setup_s, "phases": phases, "host": host, "peak": peak}
    if traced or any(m["source"] == "device_trace"
                     for m in cell["end_to_end"]):
        out["trace"] = _traced(run, loop, model)
    del model
    loop.optimizer = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out["check"] = loop.check(state)
    # the loop's own spans, and those of the architecture's layers that it
    # hooks (``Loop.layers``)
    labels = mod.LABELS + tuple(getattr(loop, "layers", ()))
    out.update(kind=mod.SHAPE, labels=labels, backward=mod.BACKWARD)
    return out


def _traced(run: Run, loop, model) -> tr.Trace:
    path = tr.trace_path()
    run.spans.on = True
    handles = loop.span_hooks(model)
    try:
        with tr.profiled(path, run.device.type == "cuda"), \
                run.spans("window"):
            loop.traced(model, run.mix["profiled"])
        return tr.read_trace(path)
    finally:
        for handle in handles:
            handle.remove()
        run.spans.on = False
        if os.path.exists(path):
            os.remove(path)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
