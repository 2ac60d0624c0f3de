"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mdfnet_tpu_torch_lookalike", sys)
    assert "mdfnet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_tops(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert imported_tops(path) <= {"__future__", "contextlib", "torch"}, \
            path


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of each kind, on the CPU at a tiny size, in a fresh
    process: afterwards sys.modules holds none of the forbidden names."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(BENCH / 'tests')!r})
from portbench.lib import harness
from conftest import tiny
for name in ("dtu.eval", "dtu.train"):
    harness.run_cell(tiny(name), 3, 0.1, True, "cpu", time.perf_counter())
bad = harness.forbidden_modules()
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout
