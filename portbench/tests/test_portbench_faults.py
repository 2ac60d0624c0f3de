"""The comparison that decides ``correct`` fails where it must: a whole run
of each cell, past the look for a card, on the CPU at a size a test run can
hold, with the timed path broken underneath, or with the control (the
reference in the nearest precision below the configuration's) in the
program's place. The cell's own limits, loops and reference decide."""
import time

import pytest

from portbench.lib import harness, report

SEEDS = (3, 2 ** 31 + 11)
FAULTS = [("dtu.eval", "missed tile"), ("tanks.eval", "missed tile"),
          ("dtu.eval", "stale answer"), ("tanks.eval", "stale answer"),
          ("dtu.train", "unchanged state"), ("dtu.train", "half batch"),
          ("blendedmvs.train", "unchanged state"),
          ("blendedmvs.train", "half batch")]
CELLS = ["dtu.eval", "tanks.eval", "dtu.train", "blendedmvs.train"]


def correct(cell, seed, **kw):
    res = harness.run_cell(cell, seed, 0.1, False, "cpu", time.perf_counter(),
                           min_items=cell["mix"].get("check_within", 0), **kw)
    return report.correct(cell, res)[0], res["check"]["readings"]


@pytest.mark.parametrize("name,fault", FAULTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_a_planted_fault_is_not_correct(tiny_cell, name, fault, seed):
    ok, readings = correct(tiny_cell(name), seed, fault=fault)
    assert not ok, readings


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(tiny_cell, name, seed):
    ok, readings = correct(tiny_cell(name), seed, control=True)
    assert not ok, readings


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_run_is_correct(tiny_cell, name, seed):
    ok, readings = correct(tiny_cell(name), seed)
    assert ok, readings
