"""BENCHMARK.json and the files it names: names, units, keys, and that every
configuration, mix, metric and stage is a file of its own."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                         + BENCH["per_layer"], ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"] == []
    assert data["source"] == cfg["source"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert (HERE / "traffic" / f"{cell['traffic']}.json").exists()
    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell["name"]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert (HERE / "metrics" / f"{metric['name']}.py").exists()
    # every cell that reports the metric reports the end-to-end metric it moves
    moved = E2E[metric["moves"]]
    for cell in BENCH["workloads"]:
        if reports(metric, cell["name"]):
            assert reports(moved, cell["name"]), (metric["name"], cell["name"])
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
        assert (HERE / "work" / f"{metric['name'][:-len('_roofline')]}.py").exists()


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
