"""BENCHMARK.json and the data files it names: every cell's workload file
names an existing configuration, every metric resolves to a reader, names
and units keep to their characters."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.workload(cell)
    assert wl["config"] == entry["config"]
    assert wl["traffic"]["name"] == entry["traffic"]
    assert wl["chips"] == entry["chips"]
    assert wl["why"] == entry["why"] and len(wl["why"]) <= 200
    cfg = harness.config(wl["config"])
    assert (harness.ROOT / "drivers" / f"{wl['driver']}.py").exists()
    from tpurpn_torch.kernels import _build

    assert wl["kernels"] and set(wl["kernels"]) <= set(_build.SIGNATURES)
    reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(cell in m.get("workloads", []) for m in BENCH["per_layer"])
    assert cfg["name"] == entry["config"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((harness.REPO / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/configs/")
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entries(m):
    assert (harness.ROOT / "metrics" / f"{m['name']}.py").exists()
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_names_unique_and_valid():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
