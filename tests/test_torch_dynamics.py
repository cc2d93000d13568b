"""The port's plant dynamics against the JAX package on the CPU: rigid-body
dynamics (RNEA, mass matrix, forward dynamics, the frozen coefficients),
the octorotor plant (allocation, rotor lag, rotor wrench, the step) and
the flight controller (backstepping with and without its safeguards,
allocation, the plant attitude).  Inputs come from a numpy seed; float32
on both sides, rtol 1e-4 and atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.models import kinova as jkinova
from quadrotor_manipulator_mppi_tpu.models import multirotor as jmr
from quadrotor_manipulator_mppi_tpu.models import rigid_body as jrb
from quadrotor_manipulator_mppi_tpu.sim import closed_loop as jcl
from quadrotor_manipulator_mppi_tpu.sim import flight_control as jfc
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu_torch.models import kinova
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr
from quadrotor_manipulator_mppi_tpu_torch.models import rigid_body as rb
from quadrotor_manipulator_mppi_tpu_torch.sim import closed_loop as cl
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc

from torch_parity import N, T, torch_one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
BATCH = (3,)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=RTOL, atol=atol)


def _quat(rng, shape=()):
    q = rng.normal(size=shape + (4,)) * np.array([1.0, 0.15, 0.15, 0.4]) + np.array([1, 0, 0, 0])
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def arm():
    rng = np.random.default_rng(0)
    lo, hi = kinova.JOINT_LOWER, kinova.JOINT_UPPER
    q = rng.uniform(np.maximum(lo, -3.0), np.minimum(hi, 3.0), size=BATCH + (7,))
    quat = _quat(rng, BATCH)
    return {
        "q": q.astype(np.float32), "qd": rng.normal(0, 0.8, BATCH + (7,)).astype(np.float32),
        "qdd": rng.normal(0, 2.0, BATCH + (7,)).astype(np.float32),
        "tau": rng.normal(0, 3.0, BATCH + (7,)).astype(np.float32),
        "rot": np.asarray(jrot.quat_to_matrix(jnp.asarray(quat))),
        "spec": kinova.chain(), "jspec": jkinova.chain(),
        "inert": kinova.inertials(), "jinert": jkinova.inertials(),
    }


def _jax_and_port(a, name):
    """(JAX value, port value) of one rigid-body function at ``a``."""
    j = {k: jnp.asarray(a[k]) for k in ("q", "qd", "qdd", "tau", "rot")}
    t = {k: T(a[k]) for k in ("q", "qd", "qdd", "tau", "rot")}
    js, ji, ts, ti = a["jspec"], a["jinert"], a["spec"], a["inert"]
    if name == "rnea":
        jt, jw = jrb.rnea(js, ji, j["q"], j["qd"], j["qdd"], base_rot=j["rot"])
        tt, tw = rb.rnea(ts, ti, t["q"], t["qd"], t["qdd"], base_rot=t["rot"])
        return (jt, jw.ang, jw.lin), (tt, tw.ang, tw.lin)
    if name == "rnea_floating_base":
        jv = jrb.SpatialVel(ang=j["qd"][..., :3], lin=j["qd"][..., 3:6])
        ja = jrb.SpatialVel(ang=j["qdd"][..., :3], lin=j["qdd"][..., 3:6])
        tv = rb.SpatialVel(ang=t["qd"][..., :3], lin=t["qd"][..., 3:6])
        ta = rb.SpatialVel(ang=t["qdd"][..., :3], lin=t["qdd"][..., 3:6])
        jt, jw = jrb.rnea(js, ji, j["q"], j["qd"], j["qdd"], base_vel=jv, base_acc=ja)
        tt, tw = rb.rnea(ts, ti, t["q"], t["qd"], t["qdd"], base_vel=tv, base_acc=ta)
        return (jt, jw.ang, jw.lin), (tt, tw.ang, tw.lin)
    if name == "gravity_torque":
        return ((jrb.gravity_torque(js, ji, j["q"], base_rot=j["rot"]),),
                (rb.gravity_torque(ts, ti, t["q"], base_rot=t["rot"]),))
    if name == "nonlinear_effects":
        return ((jrb.nonlinear_effects(js, ji, j["q"], j["qd"], base_rot=j["rot"]),),
                (rb.nonlinear_effects(ts, ti, t["q"], t["qd"], base_rot=t["rot"]),))
    if name == "mass_matrix":
        return (jrb.mass_matrix(js, ji, j["q"]),), (rb.mass_matrix(ts, ti, t["q"]),)
    if name == "forward_dynamics":
        return ((jrb.forward_dynamics(js, ji, j["q"], j["qd"], j["tau"], base_rot=j["rot"]),),
                (rb.forward_dynamics(ts, ti, t["q"], t["qd"], t["tau"], base_rot=t["rot"]),))
    if name == "forward_dynamics_chol":
        jc = jnp.linalg.cholesky(jrb.mass_matrix(js, ji, j["q"]))
        tc = torch.linalg.cholesky(rb.mass_matrix(ts, ti, t["q"]))
        return ((jrb.forward_dynamics_chol(js, ji, j["q"], j["qd"], j["tau"], jc,
                                           base_rot=j["rot"]),),
                (rb.forward_dynamics_chol(ts, ti, t["q"], t["qd"], t["tau"], tc,
                                          base_rot=t["rot"]),))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["rnea", "rnea_floating_base", "gravity_torque",
                                  "nonlinear_effects", "mass_matrix", "forward_dynamics",
                                  "forward_dynamics_chol"])
def test_rigid_body_matches_jax(arm, name):
    want, got = _jax_and_port(arm, name)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, atol=1e-4 if "forward" in name else ATOL)


@pytest.fixture(scope="module")
def frozen(arm):
    """The frozen coefficients at the first sample's q on both sides, and a
    tilted-gravity a0 with a joint-velocity and torque sample."""
    q0 = arm["q"][0]
    jco = jrb.frozen_arm_coeffs(arm["jspec"], arm["jinert"], jnp.asarray(q0))
    tco = rb.frozen_arm_coeffs(arm["spec"], arm["inert"], T(q0))
    a0 = (9.81 * arm["rot"][0][2, :]).astype(np.float32)
    return jco, tco, a0, arm["qd"][0], arm["tau"][0]


@pytest.mark.parametrize("field", jrb.FrozenArmCoeffs._fields)
def test_frozen_coeffs_fields_match_jax(frozen, field):
    jco, tco, *_ = frozen
    close(getattr(tco, field), getattr(jco, field), atol=1e-4 if field == "minv" else ATOL)


@pytest.mark.parametrize("fn", ["frozen_nle", "frozen_forward_dynamics",
                                "frozen_gravity_torque_on_base", "gravity_accel"])
def test_frozen_functions_match_jax(frozen, arm, fn):
    jco, tco, a0, qd, tau = frozen
    if fn == "frozen_nle":
        want, got = jrb.frozen_nle(jco, jnp.asarray(a0), jnp.asarray(qd)), \
            rb.frozen_nle(tco, T(a0), T(qd))
    elif fn == "frozen_forward_dynamics":
        want = jrb.frozen_forward_dynamics(jco, jnp.asarray(a0), jnp.asarray(qd), jnp.asarray(tau))
        got = rb.frozen_forward_dynamics(tco, T(a0), T(qd), T(tau))
    elif fn == "frozen_gravity_torque_on_base":
        want, got = jrb.frozen_gravity_torque_on_base(jco, jnp.asarray(a0)), \
            rb.frozen_gravity_torque_on_base(tco, T(a0))
    else:
        want = jrb.gravity_accel(jnp.asarray(arm["rot"]), jnp.float32)
        got = rb.gravity_accel(T(arm["rot"]), torch.float32)
    close(got, want, atol=1e-4 if fn == "frozen_forward_dynamics" else ATOL)


def test_frozen_coeffs_reproduce_the_full_rnea(arm):
    """The decomposition is exact at the frozen q: frozen nle = RNEA nle."""
    t = {k: T(arm[k]) for k in ("q", "qd", "rot")}
    co = rb.frozen_arm_coeffs(arm["spec"], arm["inert"], t["q"])   # batched over BATCH
    nle = rb.nonlinear_effects(arm["spec"], arm["inert"], t["q"], t["qd"], base_rot=t["rot"])
    torch.testing.assert_close(rb.frozen_nle(co, rb.gravity_accel(t["rot"]), t["qd"]), nle,
                               rtol=RTOL, atol=1e-4)


# ---------------------------------------------------------------------------
# The octorotor plant
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plant_inputs():
    rng = np.random.default_rng(1)
    return {
        "pos": rng.normal(0, 1, BATCH + (3,)) + np.array([0, 0, 2.0]),
        "quat": _quat(rng, BATCH), "vel": rng.normal(0, 0.5, BATCH + (3,)),
        "omega": rng.normal(0, 0.3, BATCH + (3,)),
        "rotor": rng.uniform(150, 400, BATCH + (8,)), "cmd": rng.uniform(-50, 700, BATCH + (8,)),
        "f_ext": rng.normal(0, 2, BATCH + (3,)), "t_ext": rng.normal(0, 5, BATCH + (3,)),
        "u": np.concatenate([rng.uniform(150, 250, BATCH + (1,)),
                             rng.normal(0, 10, BATCH + (3,))], -1),
    }


def test_allocation_and_hover_match_jax():
    jv, tv = jmr.MultirotorParams(), mr.MultirotorParams()
    np.testing.assert_array_equal(tv.allocation_matrix(), jv.allocation_matrix())
    np.testing.assert_array_equal(tv.allocation_pinv(), jv.allocation_pinv())
    assert tv.hover_rotor_speed(5.54) == jv.hover_rotor_speed(5.54)
    cfg = ((0.3, 0.5, 4e-4, 0.02, 1), (2.0, 0.5, 4e-4, 0.02, -1), (3.5, 0.5, 4e-4, 0.02, 1),
           (5.1, 0.5, 4e-4, 0.02, -1))
    jr, tr = jmr.MultirotorParams(rotor_config=cfg), mr.MultirotorParams(rotor_config=cfg)
    np.testing.assert_array_equal(tr.allocation_pinv(), jr.allocation_pinv())
    assert tr.hover_rotor_speed() == jr.hover_rotor_speed()


@pytest.mark.parametrize("fn", ["rotor_lag", "wrench_from_rotors", "step", "step_ground",
                                "allocate"])
def test_multirotor_matches_jax(plant_inputs, fn):
    x = {k: v.astype(np.float32) for k, v in plant_inputs.items()}
    jv, tv = jmr.MultirotorParams(), mr.MultirotorParams()
    if fn == "rotor_lag":
        want = (jmr.rotor_lag(jv, jnp.asarray(x["rotor"]), jnp.asarray(x["cmd"]), 0.001),)
        got = (mr.rotor_lag(tv, T(x["rotor"]), T(x["cmd"]), 0.001),)
    elif fn == "wrench_from_rotors":
        want = jmr.wrench_from_rotors(jv, jnp.asarray(x["rotor"]), jnp.asarray(x["vel"]))
        got = mr.wrench_from_rotors(tv, T(x["rotor"]), T(x["vel"]))
    elif fn == "allocate":
        want = (jfc.allocate(jv, jnp.asarray(x["u"])),)
        got = (fc.allocate(tv, T(x["u"])),)
    else:
        if fn == "step_ground":  # some rows start on the ground
            x["pos"][..., 2] = np.array([0.0, 0.0005, 1.0], np.float32)
            x["vel"][..., 2] = -0.8
        names = ("pos", "quat", "vel", "omega", "rotor")
        want = jmr.step(jv, jmr.MultirotorState(*(jnp.asarray(x[k]) for k in names)),
                        jnp.asarray(x["cmd"]), 0.001, extra_mass=5.54,
                        external_wrench_body=(jnp.asarray(x["f_ext"]), jnp.asarray(x["t_ext"])))
        got = mr.step(tv, mr.MultirotorState(*(T(x[k]) for k in names)), T(x["cmd"]), 0.001,
                      extra_mass=5.54, external_wrench_body=(T(x["f_ext"]), T(x["t_ext"])))
    for w, g in zip(want, got):
        close(g, w, atol=1e-4)


def test_init_state_and_step_refusals():
    st = mr.init_state(mr.MultirotorParams(), pos=(0.0, 1.0, 2.0), batch_shape=(2,))
    js = jmr.init_state(jmr.MultirotorParams(), pos=(0.0, 1.0, 2.0), batch_shape=(2,))
    for g, w in zip(st, js):
        np.testing.assert_array_equal(N(g), np.asarray(w))
    # The wind branch no longer raises (the flight layer's port): it steps
    # as the JAX plant does.
    wind = np.array([1.0, -0.5, 0.2], np.float32)
    got = mr.step(mr.MultirotorParams(), st, torch.full((2, 8), 300.0), 0.001,
                  wind_world=T(wind))
    want = jmr.step(jmr.MultirotorParams(), js, jnp.full((2, 8), 300.0), 0.001,
                    wind_world=jnp.asarray(wind))
    for w, g in zip(want, got):
        close(g, w, atol=1e-5)


# ---------------------------------------------------------------------------
# The flight controller
# ---------------------------------------------------------------------------

SAFEGUARDS = {"none": {}, "safeguards": dict(tilt_clip=0.3, m_hat_range=(15.0, 25.0),
                                              n_hat_clip=0.01, int_clip=0.02),
              "acc_ff": dict(acc_ff=np.array([0.3, -0.2, 0.5], np.float32))}


@pytest.mark.parametrize("guard", sorted(SAFEGUARDS))
def test_backstepping_matches_jax(plant_inputs, guard):
    rng = np.random.default_rng(2)
    x = {k: v.astype(np.float32)[0] for k, v in plant_inputs.items()}
    ctrl = [rng.normal(0, 0.05, 3), rng.normal(0, 0.1, 3), 20.24 + rng.normal(0, 1.0, 3),
            rng.normal(0, 0.02, 2)]
    ctrl = [c.astype(np.float32) for c in ctrl]
    sp = [x["pos"] + rng.normal(0, 0.4, 3).astype(np.float32), rng.normal(0, 0.2, 3),
          np.float32(0.3), np.float32(0.05)]
    sp = [np.asarray(s, np.float32) for s in sp]
    rpy = np.array([0.05, -0.04, 0.2], np.float32)
    tau_g = rng.normal(0, 5, 3).astype(np.float32)
    kw = SAFEGUARDS[guard]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (T(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ju, jc = jfc.backstepping_step(
        jfc.FlightGains(), jmr.MultirotorParams(), jfc.FlightCtrlState(*map(jnp.asarray, ctrl)),
        jfc.FlightSetpoint(*map(jnp.asarray, sp)), pos=jnp.asarray(x["pos"]),
        vel_world=jnp.asarray(x["vel"]), rpy=jnp.asarray(rpy), omega_body=jnp.asarray(x["omega"]),
        dt=0.001, tau_g=jnp.asarray(tau_g), yaw_mom=jnp.asarray(np.float32(0.4)), **jkw)
    tu, tc = fc.backstepping_step(
        fc.FlightGains(), mr.MultirotorParams(), fc.FlightCtrlState(*map(T, ctrl)),
        fc.FlightSetpoint(*map(T, sp)), pos=T(x["pos"]), vel_world=T(x["vel"]), rpy=T(rpy),
        omega_body=T(x["omega"]), dt=0.001, tau_g=T(tau_g), yaw_mom=T(np.float32(0.4)), **tkw)
    close(tu, ju, atol=1e-4)
    for g, w in zip(tc, jc):
        close(g, w)


def test_rpy_of_and_init_ctrl_state_match_jax(plant_inputs):
    quat = plant_inputs["quat"].astype(np.float32)
    jst = jmr.init_state(jmr.MultirotorParams(), batch_shape=BATCH)._replace(quat=jnp.asarray(quat))
    tst = mr.init_state(mr.MultirotorParams(), batch_shape=BATCH)._replace(quat=T(quat))
    close(cl.rpy_of(tst), jcl.rpy_of(jst))
    for g, w in zip(fc.init_ctrl_state(20.24), jfc.init_ctrl_state(20.24)):
        np.testing.assert_array_equal(N(g), np.asarray(w))
