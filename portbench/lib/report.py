"""The result line of a run: the end-to-end metrics of a ``--trace 0`` run
or the per-layer metrics of a ``--trace 1`` run, the device, the breakdown
of the traced window, whether the run was correct, and every number
compared beside its limit."""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import harness, readers
from portbench.lib import trace as tr


def _maps_per_s(cell, res):
    return res["host"]["items"] / res["host"]["seconds"]


def _train_samples_per_s(cell, res):
    return (res["host"]["items"] * cell["cfg"]["train"]["batch"]
            / res["host"]["seconds"])


def _map_device_ms(cell, res):
    """The card's busy ms a map: the union of its operations over the
    profiled sub-window after the window, per map."""
    return res["trace"].busy_us / 1e3 / cell["mix"]["profiled"]


def _peak_mem_mib(cell, res):
    return res["peak"] / 2 ** 20


def _setup_s(cell, res):
    return res["setup_s"]


END_TO_END = {"maps_per_s": _maps_per_s,
              "map_device_ms": _map_device_ms,
              "train_samples_per_s": _train_samples_per_s,
              "peak_mem_mib": _peak_mem_mib, "setup_s": _setup_s}


def checks(cell: dict, res: dict) -> dict:
    """Each number compared, with its limit, in the limits' order."""
    readings = res["check"]["readings"]
    return {k: {"value": readings[k], "limit": lim}
            for k, lim in cell["limits"].items()}


def correct(cell: dict, res: dict) -> tuple[bool, int]:
    """(correct, failed): every number within its limit, every checked
    answer present, every loss of the window finite."""
    over = sum(v["value"] > v["limit"] or not np.isfinite(v["value"])
               for v in checks(cell, res).values())
    failed = over + res["check"]["missing"] + res["host"].get("nonfinite", 0)
    return failed == 0, failed


def result_line(cell: dict, res: dict, traced: bool) -> dict:
    ok, failed = correct(cell, res)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["cell"]["chips"], "memory_peak_bytes": res["peak"],
              "power_limit": harness.power_limit()}
    line = {"correct": ok, "attempted": res["host"]["items"],
            "failed": failed, "device": device}
    if not traced:
        line["metrics"] = {m["name"]: {"value": END_TO_END[m["name"]](cell, res),
                                       "unit": m["unit"]}
                           for m in cell["end_to_end"]}
    else:
        t = res["trace"]
        reading = readers.Reading(t, cell["mix"]["profiled"], res["host"],
                                  cell["cfg"], res["kind"])
        metrics = {}
        for m in cell["per_layer"]:
            value = harness.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        device["busy_s"] = t.busy_us * 1e-6
        device["window_s"] = (t.window[1] - t.window[0]) * 1e-6
        line["breakdown"] = tr.breakdown(t, res["labels"], res["backward"])
    line["checks"] = checks(cell, res)
    return line


def check_lines(line: dict) -> list[str]:
    """The numbers compared, each beside its limit, for standard error."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in line["checks"].items()] + [
        f"correct: {line['correct']}"]
