"""Port models vs the JAX package: chain FK, link positions, the arm gravity
moment, the host horizon operators and the whole-body rollout in every
mode (the wrench mode's parallel-in-time and sequential rollouts), on the
same random joints, base pose and actions; then the JAX package's own
comparisons of the two wrench rollouts (``tests/test_whole_body.py``) on
the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from quadrotor_manipulator_mppi_tpu.models import chain as jchain
from quadrotor_manipulator_mppi_tpu.models import kinova as jkinova
from quadrotor_manipulator_mppi_tpu.models import whole_body as jwbm
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch.models import chain as tchain
from quadrotor_manipulator_mppi_tpu_torch.models import kinova as tkinova
from quadrotor_manipulator_mppi_tpu_torch.models import whole_body as twbm

from torch_parity import N, T, obs_to_port, perturbed_obs, torch_one_thread  # noqa: F401


def _base_pose(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return rng.normal(size=shape + (3,)).astype(np.float32), q


@pytest.mark.parametrize("tip", ["link_7", "end_effector"])
def test_fk_posquat_matches_jax(rng, tip):
    spec_j, spec_t = jkinova.chain(tip), tkinova.chain(tip)
    q = rng.uniform(-3, 3, size=(8, 12, 7)).astype(np.float32)
    bp, bq = _base_pose(rng, (8, 12))
    pj, qj = jchain.forward_kinematics_posquat(spec_j, jnp.asarray(q), jnp.asarray(bp), jnp.asarray(bq))
    pt, qt = tchain.forward_kinematics_posquat(spec_t, T(q), T(bp), T(bq))
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(N(qt), np.asarray(qj), atol=1e-5, rtol=0)
    # without a base pose (chain root frame)
    pj, qj = jchain.forward_kinematics_posquat(spec_j, jnp.asarray(q))
    pt, qt = tchain.forward_kinematics_posquat(spec_t, T(q))
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(N(qt), np.asarray(qj), atol=1e-5, rtol=0)


def test_chain_spec_equals_jax():
    sj, st = jkinova.chain("end_effector"), tkinova.chain("end_effector")
    for f in dataclasses.fields(sj):
        a, b = getattr(sj, f.name), getattr(st, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    for name in ("mass", "com", "inertia"):
        np.testing.assert_array_equal(getattr(jkinova.inertials(), name),
                                      getattr(tkinova.inertials(), name))
    for j in range(7):
        np.testing.assert_array_equal(jchain.matrix_to_quat_np(sj.origin_rot[j]),
                                      tchain.matrix_to_quat_np(st.origin_rot[j]))


def test_link_positions_matches_jax(rng):
    q = rng.uniform(-3, 3, size=(16, 7)).astype(np.float32)
    com = jkinova.inertials().com
    got = tchain.link_positions_posquat(tkinova.chain(), T(q), com)
    want = jchain.link_positions_posquat(jkinova.chain(), jnp.asarray(q), com)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5, rtol=0)


def test_arm_gravity_torque_matches_jax(rng):
    q = rng.uniform(-3, 3, size=(16, 7)).astype(np.float32)
    rpy = rng.uniform(-0.4, 0.4, size=3).astype(np.float32)
    from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot

    r = np.asarray(jrot.euler_to_matrix(jnp.asarray(rpy[::-1].copy()), "ZYX"))
    got = twbm.arm_gravity_torque_fast(tkinova.chain(), tkinova.inertials(), T(q), T(r))
    want = jwbm.arm_gravity_torque_fast(jkinova.chain(), jkinova.inertials(), jnp.asarray(q), jnp.asarray(r))
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("h", [12, 50])
def test_host_operators_equal_jax(h):
    dt = 0.01
    for alpha in (1.0, 0.995, 0.88):
        for a, b in zip(twbm._drag_decay_operator(h, alpha), jwbm._drag_decay_operator(h, alpha)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(twbm._rotor_lag_matrix(h, dt, 0.02),
                                  jwbm._rotor_lag_matrix(h, dt, 0.02))
    for kp, kd in ((100.0, 18.0), (20.0, 9.0), (1.7, 2.1), (9.0, 5.4)):
        for a, b in zip(twbm._attitude_response_matrices(h, dt, kp, kd),
                        jwbm._attitude_response_matrices(h, dt, kp, kd)):
            np.testing.assert_array_equal(a, b)


ROLLOUT_CASES = {
    "attitude": dict(control_mode="attitude"),
    "position": dict(control_mode="position"),
    "wrench_coupled": dict(control_mode="wrench", couple_arm_gravity=True),
    "wrench_drag": dict(control_mode="wrench", drag_kd=0.5),
    "wrench_rate_damping": dict(control_mode="wrench", rate_damping=12.0),
    "wrench_sequential": dict(control_mode="wrench", time_parallel=False),
    "wrench_sequential_damped_drag": dict(control_mode="wrench", time_parallel=False,
                                          couple_arm_gravity=True, rate_damping=12.0,
                                          drag_kd=0.5),
}


@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_rollout_matches_jax(rng, case):
    k, h = 32, 16
    jp = dataclasses.replace(jwbm.WholeBodyParams(), **ROLLOUT_CASES[case])
    tp = dataclasses.replace(twbm.WholeBodyParams(), **ROLLOUT_CASES[case])
    jobs = perturbed_obs(jwb.default_obs())
    nominal = jwb.default_nominal_action() if jp.control_mode != "position" else np.zeros(11)
    scale = np.asarray([8.0, 0.1, 0.1, 0.1] + [1.0] * 7)
    if jp.control_mode == "wrench":
        scale = np.asarray([8.0, 2.0, 2.0, 1.0] + [1.0] * 7)
    actions = (nominal + rng.normal(size=(k, h, 11)) * scale).astype(np.float32)
    ee_j, q_j, qd_j, base_j = jwbm.rollout(jp, jobs.state, jnp.asarray(actions), 0.01)
    ee_t, q_t, qd_t, base_t = twbm.rollout(tp, obs_to_port(jobs).state, T(actions), 0.01)
    np.testing.assert_allclose(N(ee_t.position), np.asarray(ee_j.position), atol=1e-4, rtol=0)
    np.testing.assert_allclose(N(ee_t.quat), np.asarray(ee_j.quat), atol=1e-4, rtol=0)
    np.testing.assert_allclose(N(q_t), np.asarray(q_j), atol=1e-5, rtol=0)
    for name in ("pos", "vel", "quat", "omega"):
        np.testing.assert_allclose(N(getattr(base_t, name)), np.asarray(getattr(base_j, name)),
                                   atol=1e-4, rtol=1e-4)


def test_hover_nominal_matches_jax():
    got = twbm.hover_nominal_action(twbm.WholeBodyParams(), 10)
    want = jwbm.hover_nominal_action(jwbm.WholeBodyParams(), 10)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-7)


# The JAX package's comparisons of the parallel-in-time and the sequential
# rollout (tests/test_whole_body.py), on the port, on the JAX tests' draws.

def _jax_actions(key, sigma, k=16, h=40):
    import jax

    noise = jax.random.normal(jax.random.key(key), (k, h, 11)) * jnp.asarray(sigma, jnp.float32)
    return T(np.asarray(jwbm.hover_nominal_action(jwbm.WholeBodyParams(), h)[None] + noise))


def test_parallel_rollout_matches_scan_rollout():
    from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

    obs = twb.default_obs(device="cpu")
    actions = _jax_actions(3, jwb.default_sigma())
    ee_p, q_p, _, base_p = twbm.rollout(twbm.WholeBodyParams(time_parallel=True), obs.state,
                                        actions, 0.01)
    ee_s, q_s, _, base_s = twbm.rollout(twbm.WholeBodyParams(time_parallel=False), obs.state,
                                        actions, 0.01)
    np.testing.assert_allclose(N(q_p), N(q_s), atol=1e-5)
    np.testing.assert_allclose(N(base_p.pos), N(base_s.pos), atol=2e-2)
    qd = np.abs(np.sum(N(base_p.quat) * N(base_s.quat), axis=-1))
    assert qd.min() > 1 - 2e-4, f"quat mismatch: min dot {qd.min()}"
    np.testing.assert_allclose(N(ee_p.position), N(ee_s.position), atol=3e-2)


def test_drag_kd_parallel_matches_scan():
    from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

    obs = twb.default_obs(device="cpu")
    actions = _jax_actions(5, jwb.default_sigma())
    params = {tp: twbm.WholeBodyParams(control_mode="wrench", time_parallel=tp, drag_kd=0.8)
              for tp in (True, False)}
    _, _, _, base_p = twbm.rollout(params[True], obs.state, actions, 0.01)
    _, _, _, base_s = twbm.rollout(params[False], obs.state, actions, 0.01)
    np.testing.assert_allclose(N(base_p.vel), N(base_s.vel), atol=2e-2)
    np.testing.assert_allclose(N(base_p.pos), N(base_s.pos), atol=2e-2)
    _, _, _, base_0 = twbm.rollout(twbm.WholeBodyParams(control_mode="wrench"), obs.state,
                                   actions, 0.01)
    v_drag = np.linalg.norm(N(base_p.vel[:, -1]), axis=-1).mean()
    v_free = np.linalg.norm(N(base_0.vel[:, -1]), axis=-1).mean()
    assert v_drag < v_free


def test_rate_damping_parallel_matches_scan():
    from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

    obs = twb.default_obs(device="cpu")
    state = obs.state._replace(base=obs.state.base._replace(omega=T([0.4, -0.3, 0.2])))
    actions = _jax_actions(7, jwb.wrench_sigma())
    params = {tp: twbm.WholeBodyParams(control_mode="wrench", time_parallel=tp,
                                       rate_damping=8.0) for tp in (True, False)}
    _, _, _, base_p = twbm.rollout(params[True], state, actions, 0.01)
    _, _, _, base_s = twbm.rollout(params[False], state, actions, 0.01)
    np.testing.assert_allclose(N(base_p.omega), N(base_s.omega), atol=1e-4)
    np.testing.assert_allclose(N(base_p.pos), N(base_s.pos), atol=3e-2)
    _, _, _, base_u = twbm.rollout(twbm.WholeBodyParams(control_mode="wrench"), state, actions,
                                   0.01)
    w_damp = np.linalg.norm(N(base_p.omega[:, -1]), axis=-1).mean()
    w_free = np.linalg.norm(N(base_u.omega[:, -1]), axis=-1).mean()
    assert w_damp < 0.7 * w_free
