"""The check sees each fault a cell can have: a run with the plain reference
in the program's place and one fault planted comes out not correct, and the
program's own run correct, on the CPU at tiny sizes (the harness's look for
a card skipped).  The control (TF32) changes nothing on the CPU; it runs on
the card (``test_portbench_card.py``)."""

import pytest

from test_portbench_harness import run_cpu

CELLS = {
    "wb_att_k4096.serve_b1": {"B": 1},
    "wb_att_k4096.batch_b256": {"B": 3, "check": {"every": 3, "sampled_vehicles": 3}},
    "wb_pos_k512.fleet_b256": {"B": 3, "check": {"steps": 3, "sampled_vehicles": 3}},
    "wb_att_k4096.reach_b1": {"B": 1, "check": {"steps": 3}},
}
FAULTS = ("unchanged_state", "half_samples", "altered_answer")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_is_correct(cell):
    rc, res = run_cpu(cell, CELLS[cell])
    assert rc == 0 and res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault):
    rc, res = run_cpu(cell, CELLS[cell], stand_in=f"fault:{fault}")
    assert rc == 0 and res["correct"] is False, res["checks"]
