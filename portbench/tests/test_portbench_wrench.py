"""The direct-wrench cells on the CPU at tiny sizes (the harness's look for a
card skipped): the program's run correct, each planted fault not, and the
control not; each cell listed wherever its attitude twin is."""

import json
from pathlib import Path

import pytest

from test_portbench_harness import run_cpu

ROOT = Path(__file__).resolve().parents[2]

CELLS = {
    "wb_wrench_k4096.batch_b256": {"B": 3, "check": {"every": 3, "sampled_vehicles": 3}},
    "wb_wrench_k4096.reach_b1": {"B": 1, "check": {"steps": 3}},
}
FAULTS = ("unchanged_state", "half_samples", "altered_answer")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_cell_shares_its_mix_and_limits_with_the_attitude_cell(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    twin = f"wb_att_k4096.{entry['traffic']}"
    limits = json.loads((ROOT / f"portbench/limits/{cell}.json").read_text())
    assert set(limits) == set(json.loads((ROOT / f"portbench/limits/{twin}.json").read_text()))
    assert limits["control"] == "control-bf16"
    for m in BENCH["per_layer"]:
        assert (twin in m.get("workloads", [])) == (cell in m.get("workloads", [])), m["name"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_is_correct(cell):
    rc, res = run_cpu(cell, CELLS[cell])
    assert rc == 0 and res["correct"] is True, res["checks"]


@pytest.mark.parametrize("stand_in", [f"fault:{f}" for f in FAULTS] + ["control-bf16"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_and_control_are_not_correct(cell, stand_in):
    rc, res = run_cpu(cell, CELLS[cell], stand_in=stand_in)
    assert rc == 0 and res["correct"] is False, res["checks"]
