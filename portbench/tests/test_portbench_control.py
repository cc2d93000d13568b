"""The episode control: the reference's solves in bfloat16 and its plant in
float32, cast at the solver's boundary (``Reference(solver_dtype=...)``,
``drivers.EpisodeStandIn``), on the CPU at tiny sizes.  The seam leaves the
default episode bit for bit as it was: ``data/frozen_episode_parent.json``
holds the reference's float64 episodes as computed before the seam existed
(:func:`record`, one thread)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import check, drivers, inputs  # noqa: E402
from portbench.reference import solve as ref  # noqa: E402

from test_portbench_harness import run_cpu  # noqa: E402

CONFIGS = {n: json.loads((ROOT / f"portbench/configs/{n}.json").read_text())
           for n in ("wb_att_k4096", "wb_pos_k512")}
PARENT = json.loads((ROOT / "portbench/tests/data/frozen_episode_parent.json").read_text())
CASES = {"att_rnea": ("wb_att_k4096", {}, 1),
         "pos_coeffs": ("wb_pos_k512", {"arm_coeffs_per_control": True}, 2)}
RNEA = {"arm_coeffs_per_control": False, "mass_matrix_per_control": False}


def record(case: str, **kw) -> dict:
    """Two calls (3 and 2 steps, the second from the first's state at solve
    index 3) of the float64 reference at K=16, H=4, as hex floats."""
    name, loop, n = CASES[case]
    cfg = CONFIGS[name]
    st = inputs.episode_start(31, 0, cfg["task"], {"vehicles": n, "base_box_m": 0.0 if n == 1
                                                   else 0.3, "target_box_m": 0.15})
    r = ref.Reference(cfg, "cpu", torch.float64, n_samples=16, n_horizon=4, **kw)
    logs, rows = r.episode(st, loop, 3)
    logs2, rows2 = r.episode(st, loop, 2, rows, step0=3)
    rec = {f: [float(x).hex() for x in np.asarray(v).ravel()] for f, v in logs.items()}
    rec.update({"call2." + f: [float(x).hex() for x in np.asarray(v).ravel()]
                for f, v in logs2.items()})
    rec["u_prev"] = [float(x).hex() for x in rows2["u_prev"].ravel()]
    return rec


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_episode_is_bit_identical_to_the_parents(case, one_thread):
    assert record(case) == PARENT[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_solver_dtype_equal_to_the_plants_changes_nothing(case, one_thread):
    assert record(case, solver_dtype=torch.float64) == PARENT[case]


def gaps(case_loop, cfg, **kw) -> dict:
    """The check's numbers of a reference episode (K=64, H=10, 4 steps, one
    vehicle) against the float64 reference, from one start."""
    st = inputs.episode_start(2**31 + 9, 0, cfg["task"], {"vehicles": 1, "base_box_m": 0.0,
                                                          "target_box_m": 0.15})
    want = ref.Reference(cfg, "cpu", torch.float64, n_samples=64, n_horizon=10)
    got = ref.Reference(cfg, "cpu", n_samples=64, n_horizon=10, **kw)
    logs, _ = got.episode(st, case_loop, 4)
    rec = {"start": st, "carry": None, "step0": 0, "logs": logs}
    return check.episode_numbers(want, case_loop, 4, [rec])


def test_the_mixed_precision_control_parts_from_float64_more_than_float32():
    cfg = CONFIGS["wb_att_k4096"]
    f32 = gaps(RNEA, cfg, dtype=torch.float32)
    mixed = gaps(RNEA, cfg, dtype=torch.float32, solver_dtype=torch.bfloat16)
    assert np.isfinite(mixed["pos_gap_m"])
    for name in ("pos_gap_m", "pos_gap_median_m"):
        assert mixed[name] > 100 * f32[name], (name, mixed[name], f32[name])


def test_the_episode_control_lowers_the_solver_alone():
    cfg, shape = CONFIGS["wb_att_k4096"], {"K": 64, "H": 10, "B": 1, "loop": RNEA}
    ep = drivers.stand_in_adapter("control-bf16", "episode", cfg, "cpu", shape, 3, 6)
    assert (ep.ref.dtype, ep.ref.solver_dtype) == (torch.float32, torch.bfloat16)
    st = ep.start(inputs.episode_start(5, 0, cfg["task"], {"vehicles": 1, "base_box_m": 0.0,
                                                            "target_box_m": 0.15}))
    nxt, logs = ep.call(st)
    assert nxt["carry"]["u_prev"].shape == (1, 10, 11)
    assert all(np.isfinite(v).all() for v in logs.values())
    # the requests' control is unchanged: the whole reference in bfloat16
    req = drivers.stand_in_adapter("control-bf16", "packed", cfg, "cpu", shape, 3)
    assert (req.ref.dtype, req.ref.solver_dtype) == (torch.bfloat16, None)


def test_the_control_is_not_correct_on_the_reach_cell():
    rc, res = run_cpu("wb_att_k4096.reach_b1", {"B": 1, "check": {"steps": 3}},
                      stand_in="control-bf16")
    assert rc == 0 and res["correct"] is False, res["checks"]
    limits = json.loads((ROOT / "portbench/limits/wb_att_k4096.reach_b1.json").read_text())
    assert limits["control"] == "control-bf16"
