"""The benchmark's CPU tests: the cells at a size a test run can hold."""
import copy
import sys
from pathlib import Path

import pytest
import torch

# a few threads a process: several test processes on one host, each with a
# thread per core, slow each other down a hundredfold
torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(name: str) -> dict:
    """The cell as BENCHMARK.json defines it, with its configuration's sizes
    cut to 64 x 96 and its mix to a few maps or steps; its limits, loops and
    reference are the cell's own."""
    from portbench.lib import harness
    cell = copy.deepcopy(harness.load_cell(name, ROOT))
    cell["cfg"]["eval"].update(height=64, width=96, views=3, batch=1)
    cell["cfg"]["train"].update(height=64, width=96, views=3, batch=2)
    cell["mix"].update(scenes=2, check_within=4, checked=2, warmup=1,
                       batches=3, profiled=2)
    return cell


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: :func:`tiny`."""
    return tiny
