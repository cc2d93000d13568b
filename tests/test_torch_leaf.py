"""Port leaf math vs the JAX package: rotations, Savitzky-Golay, Pose, the
integrator, softmin and the whole-body cost terms, on random inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

from quadrotor_manipulator_mppi_tpu.ops import costs as jcosts
from quadrotor_manipulator_mppi_tpu.ops import integrators as jint
from quadrotor_manipulator_mppi_tpu.ops import weights as jweights
from quadrotor_manipulator_mppi_tpu.utils import pose as jpose
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu.utils import savgol as jsavgol
from quadrotor_manipulator_mppi_tpu_torch.ops import costs as tcosts
from quadrotor_manipulator_mppi_tpu_torch.ops import integrators as tint
from quadrotor_manipulator_mppi_tpu_torch.ops import weights as tweights
from quadrotor_manipulator_mppi_tpu_torch.utils import pose as tpose
from quadrotor_manipulator_mppi_tpu_torch.utils import rotations as trot
from quadrotor_manipulator_mppi_tpu_torch.utils import savgol as tsavgol

import oracle
from torch_parity import N, T, torch_one_thread  # noqa: F401


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, atol):
    np.testing.assert_allclose(N(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["quat_normalize", "quat_conjugate",
                                  "quat_to_matrix", "quat_to_axis_angle",
                                  "quat_from_xyzw", "quat_to_xyzw"])
def test_quat_unary_matches_jax(rng, name):
    q = _quats(rng) * rng.uniform(0.5, 2.0, size=(64, 1)).astype(np.float32)
    if name in ("quat_to_matrix", "quat_to_axis_angle"):
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    _close(getattr(trot, name)(T(q)), getattr(jrot, name)(jnp.asarray(q)), 1e-6)


def test_quat_multiply_and_rotate_match_jax(rng):
    qa, qb = _quats(rng), _quats(rng)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    _close(trot.quat_multiply(T(qa), T(qb)), jrot.quat_multiply(jnp.asarray(qa), jnp.asarray(qb)), 1e-6)
    _close(trot.quat_rotate(T(qa), T(v)), jrot.quat_rotate(jnp.asarray(qa), jnp.asarray(v)), 1e-6)


def test_matrix_to_quat_matches_jax_all_branches(rng):
    q = _quats(rng)
    m = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    # 180-degree rotations select each of the four Shepperd candidates.
    flips = np.stack([np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(np.pi * ax)))
                      for ax in np.eye(3, dtype=np.float32)])
    m = np.concatenate([m, flips, np.eye(3, dtype=np.float32)[None]])
    _close(trot.matrix_to_quat(T(m)), jrot.matrix_to_quat(jnp.asarray(m)), 1e-6)


@pytest.mark.parametrize("scale", [1e-9, 1e-7, 1e-3, 1.0, 3.0])
def test_axis_angle_matches_jax_with_small_angle_branches(rng, scale):
    aa = rng.normal(size=(32, 3)).astype(np.float32)
    aa = aa / np.linalg.norm(aa, axis=-1, keepdims=True) * np.float32(scale)
    _close(trot.quat_from_axis_angle(T(aa)), jrot.quat_from_axis_angle(jnp.asarray(aa)), 1e-6)
    q = np.asarray(jrot.quat_from_axis_angle(jnp.asarray(aa)))
    _close(trot.quat_to_axis_angle(T(q)), jrot.quat_to_axis_angle(jnp.asarray(q)), 1e-6)


@pytest.mark.parametrize("conv", ["ZYX", "XYZ", "YZX"])
def test_euler_round_trip_matches_jax(rng, conv):
    ang = rng.uniform(-1.2, 1.2, size=(32, 3)).astype(np.float32)
    m_t = trot.euler_to_matrix(T(ang), conv)
    _close(m_t, jrot.euler_to_matrix(jnp.asarray(ang), conv), 1e-6)
    _close(trot.matrix_to_euler(m_t, conv), ang, 1e-5)
    m = np.asarray(jrot.euler_to_matrix(jnp.asarray(ang), conv))
    _close(trot.matrix_to_euler(T(m), conv), jrot.matrix_to_euler(jnp.asarray(m), conv), 1e-6)


@pytest.mark.parametrize("h,window,order", [(12, 9, 2), (50, 9, 2), (32, 7, 3)])
def test_savgol_matrix_equals_jax(h, window, order):
    np.testing.assert_allclose(tsavgol.savgol_matrix(h, window, order),
                               jsavgol.savgol_matrix(h, window, order), atol=1e-12, rtol=0)


def test_smooth_matches_jax(rng):
    x = rng.normal(size=(3, 50, 11)).astype(np.float32)
    _close(tsavgol.smooth(T(x), 9, 2), jsavgol.smooth(jnp.asarray(x), 9, 2), 1e-6)


def test_pose_from_xyzw_matches_jax(rng):
    p = rng.normal(size=(5, 3)).astype(np.float32)
    q = _quats(rng, 5)
    got = tpose.Pose.from_xyzw(T(p), T(q))
    want = jpose.Pose.from_xyzw(jnp.asarray(p), jnp.asarray(q))
    _close(got.position, want.position, 0)
    _close(got.quat, want.quat, 0)


def test_double_integrate_matches_jax_and_oracle(rng):
    accel = rng.normal(size=(16, 32, 7))
    q0, v0 = rng.normal(size=7), rng.normal(size=7)
    q, v = tint.double_integrate(T(accel), T(q0), T(v0), 0.01)
    qj, vj = jint.double_integrate(jnp.asarray(accel, jnp.float32), jnp.asarray(q0, jnp.float32),
                                   jnp.asarray(v0, jnp.float32), 0.01)
    _close(q, qj, 1e-6)
    _close(v, vj, 1e-6)
    q_w, v_w = oracle.double_integrate(accel, q0, v0, 0.01)
    _close(q, q_w, 1e-5)
    _close(v, v_w, 1e-5)


def test_softmin_weights_matches_jax_and_oracle(rng):
    s = rng.uniform(0, 100, size=256).astype(np.float32)
    got = tweights.softmin_weights(T(s), 0.1)
    _close(got, jweights.softmin_weights(jnp.asarray(s), 0.1), 1e-6)
    _close(got, oracle.softmin_weights(s.astype(np.float64), 0.1), 1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_weighted_noise_average_matches_jax(rng):
    w = rng.dirichlet(np.ones(64)).astype(np.float32)
    noise = rng.normal(size=(64, 10, 11)).astype(np.float32)
    _close(tweights.weighted_noise_average(T(w), T(noise)),
           jweights.weighted_noise_average(jnp.asarray(w), jnp.asarray(noise)), 1e-6)


def _traj(rng, k=32, h=12):
    pos = rng.normal(size=(k, h, 3)).astype(np.float32) * 0.3
    quat = _quats(rng, k * h).reshape(k, h, 4)
    tq = _quats(rng, 1)[0]
    tp = rng.normal(size=3).astype(np.float32)
    return pos, quat, tp, tq


@pytest.mark.parametrize("mode", ["log", "euler_zyx"])
def test_pose_costs_match_jax(rng, mode):
    pos, quat, tp, tq = _traj(rng)
    for name in ("pose_stage_cost_pq", "pose_terminal_cost_pq"):
        got = getattr(tcosts, name)(T(pos), T(quat), T(tp), T(tq), 50.0, 30.0, mode)
        want = getattr(jcosts, name)(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(tp),
                                     jnp.asarray(tq), 50.0, 30.0, mode)
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    # near-zero error angles (the reachable-target regime)
    got = tcosts.orientation_error_norm_quat(T(quat), T(quat), "log")
    want = jcosts.orientation_error_norm_quat(jnp.asarray(quat), jnp.asarray(quat), "log")
    _close(got, want, 1e-6)


def test_space_costs_match_jax(rng):
    k, h = 32, 12
    pos = rng.normal(size=(k, h, 3)).astype(np.float32)
    tgt = rng.normal(size=3).astype(np.float32)
    v = rng.normal(size=(k, h, 11)).astype(np.float32)
    q = rng.uniform(-1.5, 1.5, size=(k, h, 7)).astype(np.float32)
    lo, hi = np.full(7, -1.0, np.float32), np.full(7, 1.0, np.float32)
    centers = rng.normal(size=(3, 3)).astype(np.float32)
    radii = np.asarray([0.5, 1.0, 1.5], np.float32)
    pairs = [
        (tcosts.position_stage_cost(T(pos), T(tgt), 2.0),
         jcosts.position_stage_cost(jnp.asarray(pos), jnp.asarray(tgt), 2.0)),
        (tcosts.action_cost(T(v), 0.5, 0.98), jcosts.action_cost(jnp.asarray(v), 0.5, 0.98)),
        (tcosts.joint_limit_cost(T(q), T(lo), T(hi), 0.98),
         jcosts.joint_limit_cost(jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi), 0.98)),
        (tcosts.joint_limit_soft_cost(T(q), T(lo), T(hi), 0.98),
         jcosts.joint_limit_soft_cost(jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi), 0.98)),
        (tcosts.sphere_obstacle_cost(T(pos), T(centers), T(radii), 100.0),
         jcosts.sphere_obstacle_cost(jnp.asarray(pos), jnp.asarray(centers),
                                     jnp.asarray(radii), 100.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6, atol=1e-6)
