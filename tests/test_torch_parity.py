"""The port's plant-parity tooling (``evaluation/parity.py``) against the
JAX package's, on the CPU: the float64 oracle step bit for bit, the log
comparison, and the JAX test's gates on the port's plant
(``tests/test_ros_adapter_parity.py``: single-step deviations pos < 1e-5,
vel < 1e-4, omega < 1e-4, quat < 1e-5, 1 s near-hover RMSE < 1e-4 m)."""

import json

import numpy as np
import pytest

from quadrotor_manipulator_mppi_tpu.evaluation import parity as jparity
from quadrotor_manipulator_mppi_tpu.models import multirotor as jmr
from quadrotor_manipulator_mppi_tpu_torch.evaluation import parity
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr

from torch_parity import torch_one_thread  # noqa: F401


def test_oracle_step_is_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    veh, jveh = mr.MultirotorParams(), jmr.MultirotorParams()
    hover = veh.hover_rotor_speed()
    for _ in range(20):
        quat = rng.normal(size=4)
        state = (rng.normal(0, 3, 3), quat / np.linalg.norm(quat), rng.normal(0, 2, 3),
                 rng.normal(0, 1, 3), rng.uniform(0.2, 1.3, 8) * hover)
        cmd = rng.uniform(-0.1, 1.6, 8) * hover
        jstate, tstate = state, state
        for _ in range(5):
            jstate = jparity.oracle_step(jveh, jstate, cmd, 0.001)
            tstate = parity.oracle_step(veh, tstate, cmd, 0.001)
            for a, b in zip(tstate, jstate):
                np.testing.assert_array_equal(a, b)


def test_compare_logs_matches_jax():
    rng = np.random.default_rng(1)
    a = {"pos": rng.normal(size=(120, 3)), "z": rng.normal(size=120)}
    b = {"pos": a["pos"] + rng.normal(0, 1e-3, (120, 3)), "z": rng.normal(size=100)}
    for key in ("pos", "z"):
        assert parity.compare_logs(a, b, key=key, dt=0.02) == \
            jparity.compare_logs(a, b, key=key, dt=0.02)
    a = {"pos": np.zeros((100, 3))}
    b = {"pos": np.zeros((100, 3))}
    b["pos"][50:, 0] = 0.01
    rep = parity.compare_logs(a, b, dt=0.01)
    assert rep["max_dev_m"] == pytest.approx(0.01)
    assert rep["final_dev_m"] == pytest.approx(0.01)
    assert rep["n_steps"] == 100


def test_plant_matches_float64_oracle():
    """The JAX test's gates on the port's float32 plant (CPU)."""
    rep = parity.oracle_parity_report(n_steps=1000, n_ensemble=128, device="cpu")
    dev = rep["single_step_max_dev"]
    assert dev["pos"] < 1e-5 and dev["vel"] < 1e-4
    assert dev["omega"] < 1e-4 and dev["quat"] < 1e-5
    assert rep["rmse_m"] < 1e-4, rep
    assert rep["n_steps"] == 1000 and rep["n_ensemble"] == 128 and rep["device"] == "cpu"


def test_main_compares_npz_logs(tmp_path, capsys):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    pos = np.zeros((50, 3))
    np.savez(a, pos=pos)
    pos = pos.copy()
    pos[10:, 2] = 0.002
    np.savez(b, pos=pos)
    parity.main(["compare", str(a), str(b), "--dt", "0.01"])
    out = json.loads(capsys.readouterr().out)
    assert out == jparity.compare_logs(dict(np.load(a)), dict(np.load(b)), dt=0.01)
    # A .bag log is converted through the rosbag reader, as the JAX command
    # converts it (tests/test_torch_offline.py compares a real bag): a
    # missing bag fails in both alike.
    for main in (parity.main, jparity.main):
        with pytest.raises(FileNotFoundError):
            main(["compare", str(a), str(tmp_path / "log.bag")])

