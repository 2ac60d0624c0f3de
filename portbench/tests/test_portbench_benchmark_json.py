"""BENCHMARK.json against the benchmark's contract: names, units, files
found by name, and every per-layer metric's cells reporting the end-to-end
metric that it moves."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert BENCH["command"][1].startswith(tuple(BENCH["paths"]))


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys_and_valid_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_cells_find_their_files_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        conf = configs[w["config"]]
        used.add(w["config"])
        assert (ROOT / conf["file"]).is_file()
        assert conf["file"].startswith(tuple(BENCH["paths"]))
        mix = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        loop = json.loads(mix.read_text())["loop"]
        assert (ROOT / "portbench" / "loops" / f"{loop}.py").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        e2e = {m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_per_layer_metrics_move_an_e2e_metric_of_their_cells():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_reduce_nothing_and_name_their_source():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == data["reduced"] == []
        assert data["source"] == c["source"]
