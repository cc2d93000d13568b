"""The stage work counts: the formulas at hand-worked shapes, and that no
count reads anything of the port."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

WORK = Path(__file__).resolve().parents[1] / "work"


def stage(name):
    spec = importlib.util.spec_from_file_location(f"w_{name}", WORK / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode,per_step", [("attitude", 1454), ("position", 1447)])
def test_rollout_cost_by_hand(mode, per_step):
    # draw 550, v 22, arm 28 + 14; the mode's base terms (attitude: lag 3, axes
    # 30, thrust 16, vel 6, pos 6; position: axes 30 + 3 + 12 + 3 + 6);
    # quaternion 24 + 20; FK 7 x 81; costs 8 + 40 + 8 + 8 + 5 + 5 + 84 + 10
    w = stage("rollout_cost")
    assert w.per_step(11, mode) == per_step
    (got,) = w.work({"B": 2, "K": 3, "H": 4, "A": 11, "mode": mode})
    assert got == {"flops": 2 * 3 * (4 * per_step + 60), "bytes": 2 * 4 * (4 * 11 + 54 + 3)}


def test_rollout_cost_of_the_wrench_mode_and_obstacles_by_hand():
    # as attitude, but the base's 105 (terms 61, quaternion of rpy 44) are the wrench's 107:
    # lag 12, rates 15, attitude 12 + 12 + 28, thrust 16, vel 6, pos 6; an obstacle 16
    w = stage("rollout_cost")
    assert w.per_step(11, "wrench") == 1456
    assert w.per_step(11, "attitude", 2) == 1454 + 32
    (got,) = w.work({"B": 1, "K": 3, "H": 4, "A": 11, "mode": "wrench", "n_obstacles": 2})
    assert got == {"flops": 3 * (4 * 1488 + 60), "bytes": 4 * (4 * 11 + 54 + 8 + 3)}
    with pytest.raises(ValueError, match="no work count"):
        w.per_step(11, "hover")


def test_weighted_update_by_hand():
    # n = K H A = 132; weights 4 x (3 + 4) + min 4 + du 2 x 132 = 296 per scenario
    read, draw = stage("weighted_update").work({"B": 2, "K": 4, "H": 3, "A": 11})
    assert read == {"flops": 592, "bytes": 2 * 4 * (4 + 33) + 2 * 4 * 132}
    assert draw == {"flops": 592 + 2 * 132 * 50, "bytes": 2 * 4 * (4 + 33)}


def test_plant_period_by_hand():
    # 10 + (42 + 686 + 98) + (7 + 98) + 18 + 56 + 200 + (64 + 48) + 24 + (8 + 64) + 134
    w = stage("plant_period")
    assert w.per_substep() == 1557
    (got,) = w.work({"B": 3, "substeps": 10})
    assert got == {"flops": 3 * 10 * 1557, "bytes": 3 * 4 * (2 * 46 + 21 + 343 + 9 + 49 + 4 + 7)}


def test_counts_read_nothing_of_the_port():
    for src in WORK.glob("*.py"):
        assert "quadrotor_manipulator" not in src.read_text(), src.name
    code = ("import importlib.util, sys\n"
            "for p in %r:\n"
            "    s = importlib.util.spec_from_file_location('w', p)\n"
            "    m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
            "print(sorted(n for n in sys.modules if n.startswith('quadrotor') or n == 'torch'))\n"
            % [str(p) for p in sorted(WORK.glob('*.py'))])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
