"""run.py fails loudly without a card, and never falls back to the CPU; a
traced run's line carries only the cell's per-layer metrics."""
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.lib import harness, report

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "dtu.eval", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def run(cwd: Path):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd)


def test_no_card_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        return          # the card's runs are the benchmark itself
    res = run(ROOT)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run(tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""


@pytest.mark.parametrize("name", ["dtu.eval", "dtu.train", "tanks.eval"])
def test_a_traced_line_has_every_key_and_only_the_cells_metrics(
        tiny_cell, monkeypatch, name):
    """Every reader loads and runs on a CPU trace (where a device reading
    finds nothing, its metric is left out)."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "cpu")
    cell = tiny_cell(name)
    res = harness.run_cell(cell, 5, 0.1, True, "cpu", time.perf_counter())
    line = report.result_line(cell, res, True)
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(line)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}
    assert line["metrics"], "no per-layer metric read"


@pytest.mark.parametrize("name", ["dtu.eval", "tanks.eval"])
def test_an_untraced_line_has_the_cells_end_to_end_metrics(
        tiny_cell, monkeypatch, name):
    """Every end-to-end metric of the cell, and only those; one read from
    the device's trace profiles a sub-window after the window."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "cpu")
    cell = tiny_cell(name)
    res = harness.run_cell(cell, 7, 0.1, False, "cpu", time.perf_counter())
    line = report.result_line(cell, res, False)
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    reads_trace = any(m["source"] == "device_trace"
                      for m in cell["end_to_end"])
    assert ("trace" in res) == reads_trace
    assert "breakdown" not in line
