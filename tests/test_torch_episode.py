"""The port's whole-body closed loop (``sim/whole_body_loop``) against the
JAX package's ``make_whole_body_episode`` on the CPU, with the solver's
noise shared (the JAX key chain's draws passed as ``run(..., z=...)``).

Cases: the serving configuration (position mode, frozen coefficients, the
plant-tick kernel's plain version on the port side, the Pallas kernel in
interpret mode on the JAX side), position mode on the per-substep RNEA
plant, and short attitude and wrench episodes through the other branches
of ``physics_tick``.  Tolerance atol 5e-3 on the logged EE error and the
final base position, as the JAX package's own kernel-vs-XLA episode test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.models import chain as jchain
from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwbs
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twbs
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

from torch_parity import N, T, shared_z, small, to_port, torch_one_thread  # noqa: F401

TOL = 5e-3
CASES = {
    # name: (JAX params, loop config, control steps)
    "serving": (lambda: jwbs.position_mode_params(n_samples=64, n_horizon=8),
                dict(arm_coeffs_per_control=True, plant_kernel=True), 20),
    "position_rnea": (lambda: jwbs.position_mode_params(n_samples=64, n_horizon=8), {}, 20),
    "attitude": (lambda: small(jwbs.WholeBodyMPPIParams(), k=256, h=12), {}, 5),
    "wrench": (lambda: jwbs.wrench_mode_params(n_samples=256, n_horizon=12), {}, 5),
}


def _z_chain(key, n, k, h):
    zs = []
    for _ in range(n):
        key, z = shared_z(key, k, h)
        zs.append(z)
    return np.stack(zs)


@pytest.fixture(scope="module", params=sorted(CASES))
def episodes(request):
    """(JAX logs and final plant, port logs and final plant) of one case."""
    make, loop_kw, n = CASES[request.param]
    jp = make()
    k, h = jp.mppi.n_samples, jp.mppi.n_horizon
    jrun = jwbl.make_whole_body_episode(jp, cfg=jwbl.WholeBodyLoopConfig(**loop_kw),
                                        n_control_steps=n, low_k_guard="off")
    _, jinit = jwbs.make_whole_body_solver(jp, low_k_guard="off")
    jobs = jwbs.default_obs()
    js = jinit(jax.random.key(0))
    jfinal, jlogs = jax.jit(jrun)(jwbl.init_plant(jp.model.vehicle), js, jobs.ee_target,
                                  jobs.base_target)

    tp = to_port(jp)
    run = wbl.make_whole_body_episode(tp, cfg=wbl.WholeBodyLoopConfig(**loop_kw),
                                      n_control_steps=n, low_k_guard="off", device="cpu")
    _, init = twbs.make_whole_body_solver(tp, device="cpu", low_k_guard="off")
    obs = twbs.default_obs(device="cpu")
    z = _z_chain(js.key, n, k, h)
    final, logs = run(wbl.init_plant(tp.model.vehicle, device="cpu"), init(0), obs.ee_target,
                      obs.base_target, z=T(z))
    return request.param, (jfinal, jlogs), (final, logs)


def test_episode_matches_jax(episodes):
    name, (jfinal, jlogs), (final, logs) = episodes
    assert all(bool(torch.isfinite(f).all()) for f in logs)
    assert logs.ee_err.shape == np.asarray(jlogs.ee_err).shape
    np.testing.assert_allclose(N(logs.ee_err), np.asarray(jlogs.ee_err), atol=TOL, err_msg=name)
    np.testing.assert_allclose(N(final[0].base.pos), np.asarray(jfinal[0].base.pos), atol=TOL,
                               err_msg=name)


def test_episode_logs_agree_with_jax(episodes):
    """The other logs of the same episodes: the reach metrics, the tilt and
    the base track, at the same tolerance."""
    name, (_, jlogs), (_, logs) = episodes
    for field in ("l1_cmd", "l1_meas", "tilt", "base_pos", "obj_pos"):
        np.testing.assert_allclose(N(getattr(logs, field)), np.asarray(getattr(jlogs, field)),
                                   atol=TOL, err_msg=f"{name}: {field}")
    np.testing.assert_allclose(N(logs.ori_err), np.asarray(jlogs.ori_err), atol=2 * TOL,
                               err_msg=f"{name}: ori_err")


def test_plant_kernel_outside_serving_configuration_raises():
    tp = twbs.position_mode_params(n_samples=64, n_horizon=8)
    for cfg, params in (
        (wbl.WholeBodyLoopConfig(plant_kernel=True), tp),  # no frozen coefficients
        (wbl.WholeBodyLoopConfig(plant_kernel=True, arm_coeffs_per_control=True),
         dataclasses.replace(tp, model=dataclasses.replace(tp.model, control_mode="wrench"))),
    ):
        with pytest.raises(ValueError, match="plant_kernel covers the serving configuration "
                                             "only: position mode \\+ arm_coeffs_per_control"):
            wbl.make_whole_body_episode(params, cfg=cfg, n_control_steps=5,
                                        low_k_guard="off", device="cpu")
    with pytest.raises(ValueError, match="plant_kernel covers the serving configuration"):
        jwbl.make_whole_body_episode(jwbs.position_mode_params(n_samples=64, n_horizon=8),
                                     cfg=jwbl.WholeBodyLoopConfig(plant_kernel=True),
                                     n_control_steps=5, low_k_guard="off")


def test_later_slice_features_raise():
    """The branches of the pick_weight task (a payload, contact, the
    graspable object and the gripper command) build now; what still raises
    is a call that leaves out the object's state, or passes one to an
    episode without an object."""
    from quadrotor_manipulator_mppi_tpu_torch.sim import contact as tct
    from quadrotor_manipulator_mppi_tpu_torch.sim import graspable as tgr

    tp = twbs.position_mode_params(n_samples=64, n_horizon=8)
    gp = tgr.GraspableParams()
    wbl.make_whole_body_episode(tp, cfg=wbl.WholeBodyLoopConfig(payload_mass=0.5), device="cpu")
    wbl.make_whole_body_episode(tp, contact=tct.ContactParams(), device="cpu")
    run = wbl.make_whole_body_episode(tp, graspable=gp, gripper_closed=True, device="cpu")
    _, init = twbs.make_whole_body_solver(tp, device="cpu")
    obs = twbs.default_obs(device="cpu")
    plant = wbl.init_plant(tp.model.vehicle, device="cpu")
    with pytest.raises(ValueError, match="object's state"):
        run(plant, init(0), obs.ee_target, obs.base_target)
    free = wbl.make_whole_body_episode(tp, device="cpu")
    with pytest.raises(ValueError, match="object's state"):
        free(plant, init(0), obs.ee_target, obs.base_target, tgr.init_graspable(gp, device="cpu"))


def test_pose_error_jacobian_matches_jax_jacfwd():
    """The tube servo's closed-form Jacobian equals jax.jacfwd of the JAX
    loop's pose residual, at a random arm posture, base pose and target."""
    rng = np.random.default_rng(4)
    jp = jwbs.position_mode_params(n_samples=64, n_horizon=8)
    q = rng.uniform(1.0, 4.0, 7).astype(np.float32)
    bpos = np.array([0.1, -0.2, 2.0], np.float32)
    bquat = rng.normal(size=4) * [1, 0.1, 0.1, 0.3] + [1, 0, 0, 0]
    bquat = (bquat / np.linalg.norm(bquat)).astype(np.float32)
    tquat = rng.normal(size=4)
    tquat = (tquat / np.linalg.norm(tquat)).astype(np.float32)
    tpos = np.array([0.3, 0.1, 1.6], np.float32)

    def pose_err(qq):
        p, ee_q = jchain.forward_kinematics_posquat(jp.model.chain(), qq, base_pos=bpos,
                                                    base_quat=bquat)
        qe = jrot.quat_multiply(tquat, jrot.quat_conjugate(ee_q))
        return jnp.concatenate([tpos - p, 0.3 * 2.0 * jnp.sign(qe[0]) * qe[1:]])

    err6, jac = wbl.pose_error_jacobian(to_port(jp).model.chain(), T(q), T(bpos), T(bquat),
                                        Pose(T(tpos), T(tquat)), 0.3)
    np.testing.assert_allclose(N(err6), np.asarray(pose_err(jnp.asarray(q))), atol=1e-5)
    np.testing.assert_allclose(N(jac), np.asarray(jax.jacfwd(pose_err)(jnp.asarray(q))),
                               atol=1e-5)
