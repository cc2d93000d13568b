"""The harness's arithmetic and its result line, on the CPU at tiny sizes."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import core, inputs, runner  # noqa: E402

TINY = {"K": 64, "H": 10, "warmup_calls": 2, "episode_steps": 6, "check": {"every": 3}}


def run_cpu(workload: str, extra=None, stand_in=None, seconds="0.5"):
    """One run on the CPU: (exit code, the last line of standard output)."""
    argv = ["--workload", workload, "--seed", "3000000019", "--seconds", seconds, "--trace", "0"]
    if stand_in:
        argv += ["--stand-in", stand_in]
    out = io.StringIO()
    with redirect_stdout(out):
        rc = core.main(argv, device="cpu", overrides={**TINY, **(extra or {})})
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 95, 5.0),
    (list(range(1, 101)), 95, 95),
    (list(range(1, 21)), 95, 19),
    (list(range(20, 0, -1)), 50, 10),
    ([3.0, 1.0, 2.0], 100, 3.0),
])
def test_percentile_of_all_requests(values, q, want):
    assert core.percentile(values, q) == want


def test_window_metrics_rate_over_the_whole_window():
    lat = [0.001] * 95 + [0.002] * 5
    m = runner.window_metrics(solves=100 * 4, window_s=2.0, setup_s=7.5, latencies=lat)
    assert m == {"setup_s": 7.5, "solves_per_s": 200.0, "latency_p95_ms": 1.0}
    assert "latency_p95_ms" not in runner.window_metrics(10, 1.0, 1.0)


@pytest.mark.parametrize("mods,found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax.numpy", "jaxlib.xla_client"]),
    (["quadrotor_manipulator_mppi_tpu.solver"], ["quadrotor_manipulator_mppi_tpu.solver"]),
    (["quadrotor_manipulator_mppi_tpu_torch", "quadrotor_manipulator_mppi_tpu_torch.solver"], []),
    (["jaxtyping", "flaxen", "flax.linen"], ["flax.linen"]),
])
def test_forbidden_modules_compare_whole_top_level_names(mods, found):
    assert core.forbidden_modules(mods) == found


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, io, contextlib; sys.path.insert(0, %r)\n"
            "from portbench import core\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            "    rc = core.main(['--workload', 'wb_att_k4096.serve_b1', '--seed', '5', '--seconds',"
            " '0.3', '--trace', '0'], device='cpu', overrides=%r)\n"
            "print(rc, core.forbidden_modules(sys.modules))\n" % (str(ROOT), {**TINY, "B": 1}))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "0 []"


def test_result_line_keys():
    rc, res = run_cpu("wb_att_k4096.serve_b1", {"B": 1})
    assert rc == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"setup_s", "latency_p95_ms", "solves_per_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == {"plan_gap", "setpoint_gap"}
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    assert res["attempted"] > 0 and res["failed"] == 0


def test_cell_bounds_report_the_quantity():
    """``<quantity>.<cells>``: the same number as the quantity, under the
    bound of those cells' own spread."""
    rc, res = run_cpu("wb_att_k4096.batch_b256", {"B": 2, "check": {"every": 3,
                                                                    "sampled_vehicles": 2}})
    assert rc == 0 and res["correct"] is True
    m = res["metrics"]
    assert set(m) == {"setup_s", "latency_p95_ms", "solves_per_s", "latency_p95_ms.batch",
                      "solves_per_s.batch"}
    assert m["solves_per_s.batch"] == m["solves_per_s"]
    assert m["latency_p95_ms.batch"] == m["latency_p95_ms"]


def test_no_card_no_result(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: this case is the run without one")
    assert core.main(["--workload", "wb_att_k4096.serve_b1", "--seed", "1", "--seconds", "1",
                      "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def row(stream, i: int, kind: str) -> np.ndarray:
    """Request ``i`` of ``stream`` in the ``kind`` layout: (vehicles, width)."""
    return stream.block(i // inputs.BLOCK, kind)[i % inputs.BLOCK]


def test_inputs_are_a_function_of_the_seed():
    mix = json.loads((ROOT / "portbench/traffic/batch_b256.json").read_text())
    task = json.loads((ROOT / "portbench/configs/wb_att_k4096.json").read_text())["task"]
    a, b = inputs.VehicleStream(2**31 + 77, task, mix), inputs.VehicleStream(2**31 + 77, task, mix)
    c = inputs.VehicleStream(2**31 + 78, task, mix)
    assert np.array_equal(row(a, 1234, "flat"), row(b, 1234, "flat"))
    assert np.array_equal(row(a, 5, "packed"), row(b, 5, "packed"))
    assert not np.array_equal(row(a, 1234, "flat"), row(c, 1234, "flat"))
    assert row(a, 0, "flat").shape == (256, 36) and row(a, 0, "packed").shape == (256, 37)
    # the EE target switches every target_switch_every requests, within the box
    e0, e1, e2 = (row(a, i, "ee_pos") for i in (0, 199, 200))
    assert np.array_equal(e0, e1) and not np.array_equal(e1, e2)
    off = e2 - np.asarray(task["ee_target_pos"])
    assert np.all(np.abs(off) <= mix["target_box_m"])
    q = inputs.quat_from_rpy(row(a, 0, "rpy"))
    assert np.allclose(np.linalg.norm(q, axis=-1), 1.0)


def test_episode_starts():
    mix = json.loads((ROOT / "portbench/traffic/fleet_b256.json").read_text())
    task = json.loads((ROOT / "portbench/configs/wb_pos_k512.json").read_text())["task"]
    s0, s0b, s1 = (inputs.episode_start(2**31 + 5, e, task, mix) for e in (0, 0, 1))
    assert np.array_equal(s0["pos"], s0b["pos"]) and s0["keys"] == s0b["keys"]
    assert not np.array_equal(s0["pos"], s1["pos"])
    assert np.all(np.abs(s0["pos"] - task["hover_pos"]) <= mix["base_box_m"])
    assert len(set(s0["keys"])) == 256 and all(0 <= k < 2**63 for k in s0["keys"])
