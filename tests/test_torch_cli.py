"""The port's scenario command line (``run.py``) on the CPU.

Every name of the JAX registry resolves to the port's keyword runner, and
``--platform auto`` without a card exits with a message instead of running
on the CPU.  Then the JAX package's ``tests/test_cli.py`` cases of the four
runners this command line adds, at CPU sizes with ``--platform cpu``:
``drone-waypoint`` with ``--save-log`` and the Lee refusal,
``whole-body-full`` resumed equal to continuous (K=64, H=12, 1e-5),
``whole-body-batch`` at 4 x K=64, and ``bench-scaling`` on two gloo ranks;
``--save-log`` of the other scenarios writes the JAX scenario's log
arrays, and ``evaluation/analyze.main`` reads such a file as the JAX one
does.  The other scenarios' runs are the module tests' and the card's
(``chip_smoke.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import scenarios as jscenarios
from quadrotor_manipulator_mppi_tpu.evaluation import analyze as janalyze
from quadrotor_manipulator_mppi_tpu_torch import run, scenarios
from quadrotor_manipulator_mppi_tpu_torch.evaluation import analyze
from quadrotor_manipulator_mppi_tpu_torch.scenarios import whole_body as wbs

from torch_parity import torch_one_thread  # noqa: F401


def cli(capsys, argv):
    out = run.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    return out


def test_every_jax_name_resolves_to_a_port_runner():
    assert scenarios.NAMES == jscenarios.NAMES and len(scenarios.NAMES) == 16
    args = run.parser().parse_args(["hover"])
    for name in scenarios.NAMES:
        fn = scenarios.get(name)
        assert fn.__module__.startswith("quadrotor_manipulator_mppi_tpu_torch.scenarios.")
        assert fn.__name__ == jscenarios._REGISTRY[name][1]
        assert isinstance(scenarios.kwargs(name, args), dict)


def test_no_card_exits_naming_the_cpu_platform(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["hover", "--steps", "3"])
    assert e.value.code != 0 and "--platform cpu" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_drone_waypoint_save_log(capsys, tmp_path):
    log = str(tmp_path / "log.npz")
    r = cli(capsys, ["drone-waypoint", "--steps", "30", "--save-log", log, "--platform", "cpu"])
    assert list(r)[0] == "scenario" and r["scenario"] == "drone-waypoint"
    assert np.isfinite(r["min_err_m"]) and r["log"] == log and r["device"] == "cpu"
    data = np.load(log)
    assert set(data.files) == {"pos", "rpy", "vel"} and data["pos"].shape == (30, 3)
    # The JAX analyzer and the port's read the file alike.
    argv = ["waypoint", log, "--target", "1", "2", "3.4", "--radius", "0.5"]
    mine = analyze.main(argv)
    capsys.readouterr()
    janalyze.main(argv)
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mine == theirs


def test_drone_waypoint_rejects_lee():
    with pytest.raises(SystemExit):
        run.main(["drone-waypoint", "--controller", "lee", "--steps", "10", "--platform", "cpu"])


def test_options_a_runner_lacks_are_refused():
    with pytest.raises(SystemExit, match="does not take --save-state"):
        run.main(["arm-reach", "--steps", "2", "--platform", "cpu", "--save-state", "x.npz"])


def _leaves(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k != "__meta__"}


def test_whole_body_full_resume_matches_continuous(tmp_path):
    """20 + 20 steps through a checkpoint land where one 40-step run lands
    (tests/test_cli.py's check at K=64, H=12): the final plant and solver
    state within 1e-5, the last EE error within 1e-5."""
    kw = dict(seed=0, device="cpu", n_samples=64, n_horizon=12)
    mid, end_r, end_c = (str(tmp_path / f) for f in ("mid.npz", "resumed.npz", "cont.npz"))
    log_r, log_c = {}, {}
    wbs.run_whole_body_full(steps=20, save_state=mid, **kw)
    wbs.run_whole_body_full(steps=20, resume=mid, save_state=end_r, logs=log_r, **kw)
    wbs.run_whole_body_full(steps=40, save_state=end_c, logs=log_c, **kw)
    a, b = _leaves(end_r), _leaves(end_c)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(log_r["ee_err"][-1], log_c["ee_err"][-1], atol=1e-5)
    np.testing.assert_allclose(log_r["ee_err"], log_c["ee_err"][20:], atol=1e-5)


def test_whole_body_full_cli(capsys, tmp_path):
    log = str(tmp_path / "wb.npz")
    r = cli(capsys, ["whole-body-full", "--steps", "6", "--k", "64", "--platform", "cpu",
                     "--save-log", log])
    assert r["scenario"] == "whole-body-full" and r["min_alt_m"] > 0.5
    assert set(np.load(log).files) == {"ee_err", "l1_cmd", "l1_meas", "ori_err", "base_pos", "tilt"}


def test_whole_body_batch(capsys):
    r = cli(capsys, ["whole-body-batch", "--scenarios", "4", "--k-per-device", "64", "--steps",
                     "12", "--platform", "cpu"])
    assert r["scenarios"] == 4 and r["k"] == 64 and r["steps"] == 12
    assert r["control_steps_per_s"] > 0
    assert r["l1_cmd_tail_mean_mm"] < 1500.0 and r["max_tilt_rad"] < 0.5


def test_bench_scaling_two_gloo_ranks(capsys):
    r = cli(capsys, ["bench-scaling", "--platform", "cpu", "--devices", "2", "--k-per-device",
                     "32", "--iters", "1"])
    assert r["platform"] == "cpu" and r["devices"] == 2 and r["global_k_sample_axis"] == 64
    assert np.isfinite(r["weak_eff_sample_axis"]) and np.isfinite(r["weak_eff_scenario_axis"])
    assert "note" in r


# The log arrays each JAX scenario writes with --save-log.
JAX_LOGS = {
    "hover": {"pos", "omega"},
    "figure-eight": {"err", "tilt"},
    "disturbance": {"pos", "omega"},
    "mission": {"z", "phase", "tilt"},
    "arm-reach": {"q", "ee_err", "tau"},
    "multirotor-waypoint": {"err"},
    "fixed-wing": {"pos", "speed"},
}


@pytest.mark.parametrize("name", sorted(JAX_LOGS))
def test_save_log_writes_the_jax_arrays(capsys, tmp_path, name):
    log = str(tmp_path / "log.npz")
    r = cli(capsys, [name, "--steps", "3", "--k", "64", "--platform", "cpu", "--save-log", log])
    assert r["scenario"] == name and os.path.exists(log)
    data = np.load(log)
    assert set(data.files) == JAX_LOGS[name]
    assert all(np.isfinite(data[k].astype(np.float64)).all() for k in data.files)
