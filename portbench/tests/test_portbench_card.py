"""On the card: one short run of every cell correct, and its control (the
plain reference in a lower precision in the program's place, as the
cell's limits file names it) not correct.  Each case decides in its body whether a card is present.

    python3 -m pytest portbench/tests -m cuda -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def card_run(cell: str, seed: int, *extra) -> dict:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "3", "--trace", "0", *extra],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    res = card_run(cell, 2**31 + 101)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    control = json.loads((ROOT / f"portbench/limits/{cell}.json").read_text())["control"]
    res = card_run(cell, 2**31 + 102, "--stand-in", control)
    assert res["correct"] is False, res["checks"]
