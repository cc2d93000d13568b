"""The port's rotorcraft scenarios against the JAX package's, on the CPU.

Episode level, on the same inputs and draws: 1,000 ticks of hover under
each controller (the Lee, PID and backstepping laws), the figure-eight,
the disturbance (the JAX scenario's ``fold_in`` draws fed to the port as
its turbulence normals), the raw and the smooth waypoint-file flight
(a three-waypoint file whose windows end on ticks 400, 700 and 1000, so the
schedule moves on exactly at a window end): position within 1e-4 m, and
the scenarios' metrics against the JAX scenario's printed metrics.  The
mission: four 1,000-tick windows of the JAX package's 15,000-tick
mission (the takeoff from the gear, the takeoff-complete transition, the
Land command, the touchdown), each started from the JAX carry at its first
tick: the phase, the Land command and the payload flag equal tick for
tick, position within 1e-4 m before touchdown and 1e-3 m across it.  Then
a saved and resumed mission bit-equal to the live carry's continuation,
and the tick episode's own contract (a length that is not a whole number
of control steps, the explicit normals' length).
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.models import multirotor as jmr
from quadrotor_manipulator_mppi_tpu.scenarios import rotorcraft as jrc
from quadrotor_manipulator_mppi_tpu.sim import closed_loop as jcl
from quadrotor_manipulator_mppi_tpu.sim import flight_control as jfc
from quadrotor_manipulator_mppi_tpu.sim import scenario as jsc
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr
from quadrotor_manipulator_mppi_tpu_torch.scenarios import rotorcraft as rc
from quadrotor_manipulator_mppi_tpu_torch.scenarios.common import tick_episode
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc

from torch_parity import N, T, torch_one_thread  # noqa: F401

TOL_EPISODE = 1e-4    # m, position over 1,000 ticks
TOL_TOUCHDOWN = 1e-3  # m, position across the touchdown on the gear springs
TOL_METRIC = 2e-4     # a metric the JAX scenario rounds to 4 decimals
N_STEPS = 100         # control steps of 10 ticks
WAYPOINTS = "0.4 0.0 0.0 2.0 0.0\n0.3 0.8 0.5 2.3 60.0\n0.3 0.0 0.5 2.0 -30.0\n"


@pytest.fixture(autouse=True)
def no_autograd():
    with torch.inference_mode():
        yield


def jax_scenario(fn, capsys, tmp_path, **kw):
    """A JAX scenario's printed metrics and its saved log."""
    log = tmp_path / "jax_log.npz"
    args = argparse.Namespace(seed=0, steps=N_STEPS, vehicle="harrier",
                              controller="backstepping", period=6.0, file=None, smooth=False,
                              save_log=str(log), save_state=None, resume=None)
    for k, v in kw.items():
        setattr(args, k, v)
    fn(args)
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with np.load(log) as d:
        return metrics, {k: d[k] for k in d.files}


def same_metrics(got: dict, want: dict):
    for key, value in got.items():
        if key in ("file",):
            continue
        if isinstance(value, float):
            assert abs(value - want[key]) <= TOL_METRIC, (key, value, want[key])
        elif isinstance(value, list):
            np.testing.assert_allclose(value, want[key], atol=TOL_METRIC, err_msg=key)
        else:
            assert value == want[key], (key, value, want[key])


def close(got, want, tol, what=""):
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("controller", ["lee", "pid", "backstepping"])
def test_hover_matches_jax(controller, capsys, tmp_path):
    want_m, want = jax_scenario(jrc.run_hover, capsys, tmp_path, controller=controller)
    run, start = rc.hover_episode(N_STEPS, "cpu", controller=controller)
    _, (pos, omega) = run(start(0))
    assert pos.shape == (N_STEPS * 10, 3)
    close(pos, want["pos"], TOL_EPISODE, "pos")
    close(omega, want["omega"], 1e-3, "omega")
    if controller == "lee":
        same_metrics(rc.run_hover(0, N_STEPS, "cpu", controller=controller), want_m)


def test_figure_eight_matches_jax(capsys, tmp_path):
    want_m, want = jax_scenario(jrc.run_figure_eight, capsys, tmp_path)
    run, start = rc.figure_eight_episode(N_STEPS, "cpu")
    _, (err, tilt) = run(start(0))
    close(err, want["err"], TOL_EPISODE, "tracking error")
    close(tilt, want["tilt"], TOL_EPISODE, "tilt")


def test_disturbance_matches_jax_on_its_draws(capsys, tmp_path):
    seed = 3
    want_m, want = jax_scenario(jrc.run_disturbance, capsys, tmp_path, seed=seed)
    key0 = jax.random.key(seed)
    z = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(key0, i), (3,), jnp.float32))(
        jnp.arange(N_STEPS * 10))
    run, start = rc.disturbance_episode(N_STEPS, "cpu")
    _, (pos, omega) = run(start(seed), T(z))
    close(pos, want["pos"], TOL_EPISODE, "pos")
    close(omega, want["omega"], 1e-3, "omega")
    # The port's own stream (Philox under the seed and the tick) flies the
    # same scenario: finite, and near hover.
    _, (pos_own, _) = run(start(seed))
    assert bool(torch.isfinite(pos_own).all())
    assert float((pos_own - torch.tensor(rc.DISTURBANCE_TARGET)).norm(dim=-1).max()) < 0.5


@pytest.mark.parametrize("smooth", [False, True])
def test_waypoint_file_matches_jax(smooth, capsys, tmp_path):
    path = tmp_path / "wps.txt"
    path.write_text(WAYPOINTS)
    want_m, want = jax_scenario(jrc.run_waypoint_file, capsys, tmp_path, file=str(path),
                                smooth=smooth)
    run, start, (_, _, _, n_ticks) = rc.waypoint_file_episode(str(path), "cpu", smooth=smooth)
    assert n_ticks == N_STEPS * 10
    _, logs = run(start(0))
    close(logs[0], want["pos"], TOL_EPISODE, "pos")
    if smooth:
        close(logs[1], want["ref"], 1e-6, "reference")
    same_metrics(rc.run_waypoint_file(path=str(path), device="cpu", smooth=smooth), want_m)


# --- the mission ---------------------------------------------------------

MISSION_STEPS = 1500
LAND_AFTER = MISSION_STEPS * 10 * 3 // 5
WINDOW = 1000


@pytest.fixture(scope="module")
def jax_mission():
    """The JAX scenario's mission tick over 15,000 ticks: the carry after
    every tick, and the log rows the port's mission logs."""
    veh, cfg, gains = jmr.MultirotorParams(), jsc.MissionConfig(), jfc.FlightGains()
    contact = jmr.GroundContactParams()

    def tick(carry, t):
        plant, ctrl, mission = carry
        mission = mission._replace(land_cmd=mission.land_cmd | (t > LAND_AFTER))
        mission, sp, motors_on = jsc.mission_step(cfg, mission, plant.pos, plant.vel, 0.001)
        u, ctrl = jfc.backstepping_step(gains, veh, ctrl, sp, pos=plant.pos, vel_world=plant.vel,
                                        rpy=jcl.rpy_of(plant), omega_body=plant.omega, dt=0.001)
        plant = jmr.step(veh, plant, jfc.allocate(veh, u) * motors_on, 0.001, contact=contact,
                         gear_ext=mission.gear)
        carry = (plant, ctrl, mission)
        return carry, (carry, jnp.linalg.norm(jcl.rpy_of(plant)[:2]))

    carry0 = (jmr.init_state(veh, pos=(0.0, 0.0, contact.gear_height)),
              jfc.init_ctrl_state(veh.mass), jsc.init_mission())
    _, (carries, tilt) = jax.jit(lambda c: jax.lax.scan(tick, c, jnp.arange(MISSION_STEPS * 10)))(
        carry0)
    before = jax.tree.map(lambda c0, c: np.concatenate([np.asarray(c0)[None], np.asarray(c)]),
                          carry0, carries)  # before[i]: the carry entering tick i
    return before, np.asarray(tilt)


def port_carry(before, i):
    plant, ctrl, mission = jax.tree.map(lambda x: x[i], before)
    return (mr.MultirotorState(*map(T, plant)), fc.FlightCtrlState(*map(T, ctrl)),
            convert.mission_state_from_numpy(*mission, device="cpu"))


def window_starts(before):
    phase = before[2].phase[1:]
    first = {p: int(np.argmax(phase == p)) for p in (jsc.CRUISE, jsc.LANDING, jsc.LANDED)}
    assert all(phase[v] == p for p, v in first.items()), "the JAX mission missed a phase"
    return {"takeoff": 0, "cruise": first[jsc.CRUISE] - WINDOW // 2,
            "land": first[jsc.LANDING] - WINDOW // 2, "touchdown": first[jsc.LANDED] - WINDOW // 2}


@pytest.mark.parametrize("window", ["takeoff", "cruise", "land", "touchdown"])
def test_mission_window_matches_jax(window, jax_mission):
    before, tilt = jax_mission
    a = window_starts(before)[window]
    run, _ = rc.mission_episode(WINDOW // 10, "cpu", land_after=LAND_AFTER - a)
    _, (pos, phase, tilt_p, land_cmd, payload) = run(port_carry(before, a))
    after = jax.tree.map(lambda x: x[a + 1:a + 1 + WINDOW], before)
    np.testing.assert_array_equal(N(phase), after[2].phase)
    np.testing.assert_array_equal(N(land_cmd), after[2].land_cmd)
    np.testing.assert_array_equal(N(payload), after[2].payload_attached)
    tol = TOL_TOUCHDOWN if window == "touchdown" else TOL_EPISODE
    close(pos, after[0].pos, tol, f"{window} pos")
    close(tilt_p, tilt[a:a + WINDOW], 10 * tol, f"{window} tilt")
    if window == "touchdown":  # at rest on the gear after the motor cut
        assert int(phase[-1]) == rc.mission_mod.LANDED
        assert abs(float(pos[-1, 2]) - rc.MISSION_CONTACT.gear_height) < 0.05


def test_mission_resume_continues_the_live_carry(tmp_path):
    ck = str(tmp_path / "mission.npz")
    run, start = rc.mission_episode(30, "cpu")
    live, _ = run(start(0), save_state=ck)
    cont, _ = rc.mission_episode(10, "cpu", land_after=30 * 10 * 3 // 5)
    a = cont(live)
    b = cont(start(0), resume=ck)
    flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b) and all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    assert b[0][2].phase.dtype == torch.int32 and b[0][2].land_cmd.dtype == torch.bool


def test_tick_episode_partial_step_and_noise_length():
    def tick(carry, i, noise):
        carry = carry + noise
        return carry, (carry, i)

    run = tick_episode(tick, lambda c: (c, torch.zeros((), dtype=torch.int32)), 25, "cpu")
    z = torch.arange(25, dtype=torch.float32)
    final, (acc, idx) = run(torch.zeros(()), z)
    assert acc.shape == (25,) and torch.equal(idx, torch.arange(25, dtype=torch.int32))
    assert torch.equal(acc, torch.cumsum(z, 0))
    with pytest.raises(ValueError, match="z carries 24 ticks, the episode 25"):
        run(torch.zeros(()), z[:24])
