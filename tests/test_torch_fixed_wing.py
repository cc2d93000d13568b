"""The port's fixed-wing airframe and MPPI preset against the JAX package's,
on the CPU.

Cases: ``fw_forces_moments``, ``step`` and ``liftdrag_wrench`` on random
states (1e-5 relative to the largest entry); 20 steps of trimmed flight
(1e-4); three solves of ``make_fixed_wing_solver`` on the JAX key chain's
draws (2e-4); the YAML loaders on the JAX tests' inline files; the
configuration crossing through ``convert``.  Then the JAX package's own
airframe tests (``tests/test_fixed_wing.py``) on the port alone, and the
scenario's entry point on a short episode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.models import fixed_wing as jfw
from quadrotor_manipulator_mppi_tpu.solver import fixed_wing as jfws
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models import fixed_wing as fw
from quadrotor_manipulator_mppi_tpu_torch.scenarios.solvers import fixed_wing_episode, \
    run_fixed_wing
from quadrotor_manipulator_mppi_tpu_torch.solver import fixed_wing as fws
from quadrotor_manipulator_mppi_tpu_torch.utils import rotations as rot

from torch_parity import N, T, shared_z, torch_one_thread  # noqa: F401

TOL_PHYSICS = 1e-5   # relative to the largest entry
TOL_FLIGHT = 1e-4    # 20 steps of trimmed flight
TOL_SOLVE = 2e-4     # u_seq over three solves on shared draws
AERO, VEH = fw.FwAeroParams(), fw.FwVehicleParams()
JAERO, JVEH = jfw.FwAeroParams(), jfw.FwVehicleParams()


def close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(N(got), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _random_states(n=64, seed=0):
    rng = np.random.default_rng(seed)
    vel = (rng.normal(size=(n, 3)) * 5 + [14.0, 0, 0]).astype(np.float32)
    vel[:4] = [[0.0, 0, 0], [0.05, 0, 0], [-3.0, 1.0, 0.5], [10.0, 0.0, -8.0]]  # slow, reversed
    omega = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    quat = rng.normal(size=(n, 4))
    quat = (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(n, 6)).astype(np.float32)
    act[:, 5] = rng.uniform(0, 1, size=n)
    return vel, omega, quat, act


def test_forces_moments_match_jax():
    vel, omega, _, act = _random_states()
    jf, jm = jfw.fw_forces_moments(JAERO, JVEH, jnp.asarray(vel), jnp.asarray(omega),
                                   jfw.controls_from_actuators(jnp.asarray(act)))
    f, m = fw.fw_forces_moments(AERO, VEH, T(vel), T(omega), fw.controls_from_actuators(T(act)))
    close(f, jf, TOL_PHYSICS, "force")
    close(m, jm, TOL_PHYSICS, "moment")


@pytest.mark.parametrize("wind", [False, True])
def test_step_matches_jax(wind):
    vel, omega, quat, act = _random_states(seed=1)
    pos = np.random.default_rng(2).normal(size=(len(vel), 3)).astype(np.float32) + [0, 0, 100]
    w = np.asarray([1.0, -2.0, 0.5], np.float32) if wind else None
    js = jfw.step(JAERO, JVEH, jfw.FixedWingState(*map(jnp.asarray, (pos, quat, vel, omega))),
                  jfw.controls_from_actuators(jnp.asarray(act)), 0.01,
                  None if w is None else jnp.asarray(w))
    s = fw.step(AERO, VEH, fw.FixedWingState(*map(T, (pos, quat, vel, omega))),
                fw.controls_from_actuators(T(act)), 0.01, None if w is None else T(w))
    for name, a, b in zip(s._fields, s, js):
        close(a, b, TOL_PHYSICS, name)


@pytest.mark.parametrize("case", ["plain", "stall", "radial", "cp_control"])
def test_liftdrag_matches_jax(case):
    kw = {"plain": dict(cla=5.0, cda=0.1, area=0.5),
          "stall": dict(cla=5.0, cda=0.1, cma=0.2, alpha_stall=0.3, cla_stall=-2.0,
                        cma_stall=-0.5, area=0.5),
          "radial": dict(cla=5.0, radial_symmetry=True, area=0.2),
          "cp_control": dict(cla=4.0, cma=0.1, alpha_stall=0.4, cp=(0.1, 0.8, -0.05),
                             control_joint_rad_to_cl=-0.7, alpha0=0.05)}[case]
    vel, _, quat, act = _random_states(seed=3)
    vel[0] = 0.0  # no inflow: no wrench
    rotm = np.asarray(jrot.quat_to_matrix(jnp.asarray(quat)))
    angle = act[:, 0] * 0.3
    jf, jt = jfw.liftdrag_wrench(jfw.LiftDragParams(**kw), jnp.asarray(rotm), jnp.asarray(vel),
                                 jnp.asarray(angle))
    f, t = fw.liftdrag_wrench(fw.LiftDragParams(**kw), T(rotm), T(vel), T(angle))
    close(f, jf, TOL_PHYSICS, "force")
    close(t, jt, TOL_PHYSICS, "torque")


def _trim_residual(x, speed):
    """(acc_x, acc_z, pitch moment) of level flight at pitch theta, in
    float64 (the port's model takes any float dtype), so the root finder
    sees no float32 rounding."""
    theta, elev, thr = [float(v) for v in x]
    f64 = dict(dtype=torch.float64)
    r = rot.quat_to_matrix(rot.quat_from_axis_angle(torch.tensor([0.0, theta, 0.0], **f64)))
    v_air_b = r.T @ torch.tensor([speed, 0.0, 0.0], **f64)
    f_b, m_b = fw.fw_forces_moments(AERO, VEH, v_air_b, torch.zeros(3, **f64),
                                    _controls(elev=elev, thr=thr, dtype=torch.float64))
    f_w = r @ f_b
    return np.array([float(f_w[0]) / VEH.mass, float(f_w[2]) / VEH.mass - fw.GRAVITY,
                     float(m_b[1])])


def _controls(ail=0.0, elev=0.0, flap=0.0, rud=0.0, thr=0.0, ail_diff=0.0,
              dtype=torch.float32):
    def z(x):
        return torch.tensor(x, dtype=dtype)

    return fw.FwControls(aileron_left=z(ail + ail_diff), aileron_right=z(ail - ail_diff),
                         elevator=z(elev), flap=z(flap), rudder=z(rud), throttle=z(thr))


def _solve_trim(speed=15.0):
    from scipy.optimize import fsolve

    x, info, ier, _ = fsolve(_trim_residual, np.array([0.05, 0.0, 0.4]), args=(speed,),
                             full_output=True, xtol=1e-8, epsfcn=1e-6)
    assert ier == 1, info
    return x


def _trim_state(theta, speed=15.0):
    quat = rot.quat_from_axis_angle(torch.tensor([0.0, float(theta), 0.0]))
    return fw.FixedWingState(pos=torch.tensor([0.0, 0.0, 100.0]), quat=quat,
                             vel=torch.tensor([speed, 0.0, 0.0]), omega=torch.zeros(3))


def test_trimmed_flight_matches_jax():
    """20 steps of 10 ms from the trim of 15 m/s, the JAX model scanned."""
    theta, elev, thr = _solve_trim()
    s0 = _trim_state(theta)
    js = jfw.FixedWingState(*(jnp.asarray(N(x)) for x in s0))
    jc = jfw.FwControls(*(jnp.asarray(N(x)) for x in _controls(elev=elev, thr=thr)))

    def body(s, _):
        s = jfw.step(JAERO, JVEH, s, jc, 0.01)
        return s, s

    _, jtraj = jax.lax.scan(body, js, None, length=20)
    s, traj = s0, []
    for _ in range(20):
        s = fw.step(AERO, VEH, s, _controls(elev=elev, thr=thr), 0.01)
        traj.append(s)
    for i, name in enumerate(s0._fields):
        close(torch.stack([x[i] for x in traj]), jtraj[i], TOL_FLIGHT, name)


def _jax_params(k=64, h=12):
    base = jfws.FwMPPIParams()
    return dataclasses.replace(base, mppi=dataclasses.replace(base.mppi, n_samples=k,
                                                              n_horizon=h))


def test_params_cross_through_convert():
    jp = _jax_params()
    p = convert.config_from_dict(jcfg.to_dict(jp))
    assert isinstance(p, fws.FwMPPIParams)
    assert p == dataclasses.replace(fws.FwMPPIParams(), mppi=dataclasses.replace(
        p.mppi, n_samples=64, n_horizon=12))
    assert p.aero == AERO and p.veh == VEH and p.mppi.n_samples == 64
    assert tuple(p.mppi.sigma) == (0.25, 0.25, 0.2, 0.15)


@pytest.mark.parametrize("k,h", [(64, 12), (128, 40)])
def test_solves_match_jax(k, h):
    """Three solves from a banked, pitched state on the JAX key chain's
    draws: the plan and the emitted surface commands."""
    jp = _jax_params(k, h)
    jstep, jinit = jfws.make_fixed_wing_solver(jp)
    step, init = fws.make_fixed_wing_solver(convert.config_from_dict(jcfg.to_dict(jp)),
                                            device="cpu")
    quat = np.asarray(jrot.quat_from_axis_angle(jnp.asarray([0.2, -0.05, 0.1])))
    st = [np.asarray(x, np.float32) for x in ([10.0, -5.0, 95.0], quat, [14.0, 1.0, -0.5],
                                              [0.1, -0.05, 0.02])]
    target, cruise = np.asarray([250.0, 60.0, 110.0], np.float32), np.float32(15.0)
    jobs = jfws.FwObs(state=jfw.FixedWingState(*map(jnp.asarray, st)),
                      target=jnp.asarray(target), cruise_speed=jnp.asarray(cruise))
    obs = fws.FwObs(state=fw.FixedWingState(*map(T, st)), target=T(target),
                    cruise_speed=T(cruise))
    js, s = jinit(jax.random.PRNGKey(4)), init(0)
    key, jstep = js.key, jax.jit(jstep)
    for i in range(3):
        key, z = shared_z(key, k, h, 4)
        jout, js = jstep(js, jobs)
        out, s = step(s, obs, T(z))
        close(out.u_seq, jout.u_seq, TOL_SOLVE, f"solve {i}: u_seq")
        for name, a, b in zip(out.controls._fields, out.controls, jout.controls):
            close(a, b, TOL_SOLVE, f"solve {i}: {name}")
    close(s.u_prev, js.u_prev, TOL_SOLVE, "warm start")


def test_yaml_param_loaders(tmp_path):
    """The RotorS fixed-wing YAML format: flat coefficient vectors and
    per-surface deflection maps (the JAX test's files), loaded alike."""
    aero_f = tmp_path / "aero.yaml"
    aero_f.write_text("alpha_max: 0.3\nc_lift_alpha: [0.2, 11.0, -40.0, 55.0]\n"
                      "c_thrust: [0.0, 12.5, 0.0]\nnot_a_field: 7\n")
    aero = fw.aero_params_from_yaml(str(aero_f))
    assert aero.alpha_max == 0.3 and aero.c_lift_alpha == (0.2, 11.0, -40.0, 55.0)
    assert aero.c_thrust == (0.0, 12.5, 0.0) and aero.c_drag_alpha == AERO.c_drag_alpha
    assert dataclasses.asdict(aero) == dataclasses.asdict(jfw.aero_params_from_yaml(str(aero_f)))

    veh_f = tmp_path / "veh.yaml"
    veh_f.write_text("wing_span: 2.0\nwing_surface: 0.4\nchord_length: 0.15\n"
                     "thrust_inclination: 0.05\naileron_left:\n  channel: 4\n"
                     "  deflection_min: -0.3\n  deflection_max: 0.3\n")
    veh = fw.vehicle_params_from_yaml(str(veh_f))
    assert veh.wing_span == 2.0 and veh.deflection_limit == 0.3 and veh.mass == VEH.mass
    assert dataclasses.asdict(veh) == dataclasses.asdict(jfw.vehicle_params_from_yaml(str(veh_f)))


# ---------------------------------------------------------------------------
# The JAX package's airframe tests (tests/test_fixed_wing.py) on the port
# ---------------------------------------------------------------------------

def test_trim_exists_and_is_sane():
    theta, elev, thr = _solve_trim(15.0)
    assert -0.2 < theta < 0.0
    assert abs(elev) < 1.0
    assert 0.0 < thr < 1.0
    assert np.max(np.abs(_trim_residual([theta, elev, thr], 15.0))) < 1e-3


def test_trimmed_flight_holds_altitude():
    speed = 15.0
    theta, elev, thr = _solve_trim(speed)
    s, controls, alts = _trim_state(theta, speed), _controls(elev=elev, thr=thr), []
    with torch.inference_mode():
        for _ in range(2000):
            alts.append(s.pos[2])
            s = fw.step(AERO, VEH, s, controls, 1e-3)
    assert abs(float(s.pos[2]) - 100.0) < 1.0
    assert abs(float(torch.linalg.norm(s.vel)) - speed) < 1.0
    assert bool((torch.stack(alts) - 100.0).abs().lt(1.5).all())


def _moment(v):
    return fw.fw_forces_moments(AERO, VEH, torch.tensor(v), torch.zeros(3), _controls())[1]


def test_static_stability_signs():
    v, om = torch.tensor([15.0, 0.0, 0.0]), torch.zeros(3)
    m_0 = _moment([15.0, 0.0, 0.0])
    assert float(_moment([15.0, 0.0, -1.5])[1]) > float(m_0[1])
    assert float(_moment([15.0, 0.0, 1.5])[1]) < float(m_0[1])
    assert float(_moment([15.0, -2.0, 0.0])[2]) < float(m_0[2])
    _, m_ail = fw.fw_forces_moments(AERO, VEH, v, om, _controls(ail_diff=0.5))
    assert float(m_ail[0]) > float(m_0[0])
    _, m_rud = fw.fw_forces_moments(AERO, VEH, v, om, _controls(rud=0.5))
    assert float(m_rud[2]) < float(m_0[2])


def test_throttle_thrust_quadratic():
    f0, f5, f1 = (fw.fw_forces_moments(AERO, VEH, torch.zeros(3), torch.zeros(3),
                                       _controls(thr=t))[0] for t in (0.0, 0.5, 1.0))
    assert abs(float(f0[0])) < 1e-6
    np.testing.assert_allclose(float(f5[0]), 14.7217 * 0.5, rtol=1e-5)
    np.testing.assert_allclose(float(f1[0]), 14.7217, rtol=1e-5)


def test_actuator_channel_map():
    c = fw.controls_from_actuators(torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5, 0.6]))
    assert float(c.aileron_right) == pytest.approx(0.1)
    assert float(c.elevator) == pytest.approx(0.2)
    assert float(c.flap) == pytest.approx(0.3)
    assert float(c.rudder) == pytest.approx(0.4)
    assert float(c.aileron_left) == pytest.approx(0.5)
    assert float(c.throttle) == pytest.approx(0.6)


def test_batched_matches_single():
    g = torch.Generator().manual_seed(0)
    vels = torch.randn(8, 3, generator=g) * 5 + torch.tensor([12.0, 0, 0])
    oms = torch.randn(8, 3, generator=g) * 0.3
    c = _controls(elev=0.1, thr=0.5, ail_diff=0.2)
    fb, mb = fw.fw_forces_moments(AERO, VEH, vels, oms,
                                  fw.FwControls(*(x.expand(8) for x in c)))
    for i in range(8):
        fi, mi = fw.fw_forces_moments(AERO, VEH, vels[i], oms[i], c)
        np.testing.assert_allclose(N(fb[i]), N(fi), rtol=1e-6)
        np.testing.assert_allclose(N(mb[i]), N(mi), rtol=1e-6)


def _lift_z(p, alpha, speed=10.0):
    vel = torch.tensor([speed * np.cos(alpha), 0.0, -speed * np.sin(alpha)], dtype=torch.float32)
    return float(fw.liftdrag_wrench(p, torch.eye(3), vel)[0][2])


def test_liftdrag_lift_slope_and_stall():
    p = fw.LiftDragParams(cla=5.0, cda=0.1, alpha_stall=0.3, cla_stall=-2.0, area=0.5)
    q = 0.5 * p.air_density * 10.0**2 * p.area
    for a in (0.05, 0.1, 0.2):
        np.testing.assert_allclose(_lift_z(p, a), p.cla * a * q, rtol=0.05)
    assert _lift_z(p, 0.45) < _lift_z(p, 0.29)


def test_liftdrag_drag_opposes_motion_and_rest_is_zero():
    vel = torch.tensor([10.0, 0.0, -1.0])
    f, _ = fw.liftdrag_wrench(fw.LiftDragParams(cla=5.0, cda=0.5, alpha_stall=0.3, area=0.5),
                              torch.eye(3), vel)
    assert float(torch.dot(f, vel)) < 0.0
    f, t = fw.liftdrag_wrench(fw.LiftDragParams(), torch.eye(3), torch.zeros(3))
    assert float(torch.linalg.norm(f)) == 0.0 and float(torch.linalg.norm(t)) == 0.0


def test_liftdrag_cp_offset_torque_and_radial_symmetry():
    p = fw.LiftDragParams(cla=5.0, cma=0.0, alpha_stall=0.3, area=0.5, cp=(0.0, 1.0, 0.0))
    f, t = fw.liftdrag_wrench(p, torch.eye(3), torch.tensor([10.0, 0.0, -1.0]))
    np.testing.assert_allclose(N(t), np.cross([0.0, 1.0, 0.0], N(f)), atol=1e-4)
    f, _ = fw.liftdrag_wrench(fw.LiftDragParams(cla=5.0, radial_symmetry=True, area=0.2),
                              torch.eye(3), torch.tensor([3.0, 0.0, -4.0]))
    assert bool(torch.isfinite(f).all())


def test_run_fixed_wing_on_the_cpu():
    """The scenario's entry point: the JAX scenario's metrics on a short
    episode, and the episode's first steps against the same steps run
    from its parts."""
    r = run_fixed_wing(seed=0, steps=4, device="cpu", n_samples=32)
    assert set(r) == {"closest_approach_m", "reached", "min_altitude_m", "mean_speed_ms",
                      "steps"}
    assert 95.0 < r["min_altitude_m"] < 105.0 and 13.0 < r["mean_speed_ms"] < 17.0
    params = dataclasses.replace(fws.FwMPPIParams(), mppi=dataclasses.replace(
        fws.FwMPPIParams().mppi, n_samples=32))
    run, start = fixed_wing_episode(params, 3, "cpu")
    (plant, sol), (pos, speed) = run(start(0))
    assert pos.shape == (3, 3) and speed.shape == (3,) and sol.step.tolist() == [3]
    assert torch.equal(pos[-1], plant.pos)
