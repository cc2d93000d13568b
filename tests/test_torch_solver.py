"""The port's whole-body solver vs the JAX ``backend="xla"`` solver, with the
JAX noise stream shared: each step reproduces the JAX key split and hands
the standard normals z to the port.  Both port backends are held to the
reference: the kernel step (plain versions on the CPU) and the plain
pipeline.  Tolerances are those of ``tests/test_whole_body_pallas.py``."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

from torch_parity import (  # noqa: F401
    N, obs_to_port, perturbed_obs, shared_z, small, to_port, torch_one_thread,
    wrench_params,
)


def _obstacle_params():
    p = small(jwb.WholeBodyMPPIParams())
    return dataclasses.replace(p, cost=dataclasses.replace(
        p.cost, obstacle_weight=100.0, obstacle_centers=((0.3, 0.1, 1.8),),
        obstacle_radii=(0.4,)))


def _forty_obstacle_params():
    """40 spheres around the EE's workspace: more than the 16 the CUDA
    kernel's parameter struct once carried."""
    rng = np.random.default_rng(40)
    centers = np.asarray([0.3, 0.1, 1.8]) + rng.uniform(-0.4, 0.4, (40, 3))
    p = small(jwb.WholeBodyMPPIParams())
    return dataclasses.replace(p, cost=dataclasses.replace(
        p.cost, obstacle_weight=100.0, obstacle_centers=tuple(map(tuple, centers.tolist())),
        obstacle_radii=tuple(rng.uniform(0.05, 0.3, 40).tolist())))


def _adaptive_params():
    p = small(jwb.position_mode_params())
    return dataclasses.replace(p, mppi=dataclasses.replace(
        p.mppi, adaptive_sigma=True, sigma_scale_fn=None))


def _damped_wrench_params():
    p = wrench_params(h=12)
    return dataclasses.replace(p, model=dataclasses.replace(
        p.model, rate_damping=12.0, drag_kd=0.5))


# name -> (JAX params factory, perturbed initial state?, steps, tolerance)
CASES = {
    "attitude": (lambda: small(jwb.WholeBodyMPPIParams()), False, 3, 2e-3),
    "position_schedule": (lambda: small(jwb.position_mode_params()), False, 3, 2e-3),
    "wrench_preset": (lambda: small(jwb.wrench_mode_params()), False, 3, 2e-3),
    "position_adaptive_sigma": (_adaptive_params, False, 3, 2e-3),
    "obstacle": (_obstacle_params, False, 3, 2e-3),
    "forty_obstacles": (_forty_obstacle_params, False, 3, 2e-3),
    "wrench_nonidentity_attitude": (lambda: wrench_params(h=12), True, 2, 4e-3),
    "wrench_damped_drag": (_damped_wrench_params, True, 2, 2e-3),
}


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    """(obs, [(z, u_seq, u_prev, sigma) per step]) of the JAX XLA solver."""
    make, perturb, steps, _ = CASES[case]
    params = make()
    step, init = jwb.make_whole_body_solver(params, low_k_guard="off")
    step = jax.jit(step)
    obs = perturbed_obs(jwb.default_obs()) if perturb else jwb.default_obs()
    state = init(jax.random.key(7))
    key, out = state.key, []
    for _ in range(steps):
        key, z = shared_z(key, params.mppi.n_samples, params.mppi.n_horizon)
        res, state = step(state, obs)
        out.append((z, np.asarray(res.u_seq), np.asarray(state.u_prev),
                    np.asarray(state.sigma)))
    return params, obs, out


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_jax_xla(case, backend):
    jparams, jobs, ref = _jax_reference(case)
    tol = CASES[case][3]
    step, init = twb.make_whole_body_solver(
        to_port(jparams), device="cpu", backend=backend, low_k_guard="off")
    state, obs = init(7), obs_to_port(jobs)
    for z, u_seq, u_prev, sigma in ref:
        out, state = step(state, obs, z)
        np.testing.assert_allclose(N(out.u_seq), u_seq, rtol=tol, atol=tol)
        np.testing.assert_allclose(N(state.u_prev), u_prev, rtol=tol, atol=tol)
        np.testing.assert_allclose(N(state.sigma), sigma, rtol=2e-3, atol=1e-4)


def test_solver_output_setpoints_match_jax():
    """action / qdes / vdes of the step wrapper, on the attitude case."""
    jparams, jobs, _ = _jax_reference("attitude")
    jstep, jinit = jwb.make_whole_body_solver(jparams, low_k_guard="off")
    jstep = jax.jit(jstep)
    tstep, tinit = twb.make_whole_body_solver(to_port(jparams), device="cpu", low_k_guard="off")
    js, ts = jinit(jax.random.key(3)), tinit(3)
    key = js.key
    for _ in range(2):
        key, z = shared_z(key, 256, 12)
        jout, js = jstep(js, jobs)
        tout, ts = tstep(ts, obs_to_port(jobs), z)
        for name in ("action", "qdes", "vdes"):
            np.testing.assert_allclose(N(getattr(tout, name)), np.asarray(getattr(jout, name)),
                                       rtol=2e-3, atol=2e-3)


def test_init_matches_jax():
    for make in (jwb.WholeBodyMPPIParams, jwb.position_mode_params, jwb.wrench_mode_params):
        jp = make()
        _, jinit = jwb.make_whole_body_solver(jp, low_k_guard="off")
        _, tinit = twb.make_whole_body_solver(to_port(jp), device="cpu", low_k_guard="off")
        js, ts = jinit(jax.random.key(0)), tinit(0)
        np.testing.assert_allclose(N(ts.u_prev), np.asarray(js.u_prev), rtol=1e-7)
        np.testing.assert_allclose(N(ts.sigma), np.asarray(js.sigma), rtol=1e-7)


def test_default_obs_matches_jax():
    jobs, tobs = jwb.default_obs(), twb.default_obs(device="cpu")
    for a, b in zip(jax.tree.leaves(jobs), (tobs.state.base.pos, tobs.state.base.rpy,
                                            tobs.state.base.vel, tobs.state.base.omega,
                                            tobs.state.q, tobs.state.qdot,
                                            tobs.ee_target.position, tobs.ee_target.quat,
                                            tobs.base_target)):
        np.testing.assert_allclose(N(b), np.asarray(a), rtol=1e-7)


def test_philox_stream_is_deterministic_per_seed():
    """Without z the solve draws the Philox stream of (seed, step): the two
    backends agree, and the same seed reproduces the plan."""
    params = to_port(small(jwb.position_mode_params()))
    obs = twb.default_obs(device="cpu")
    results = []
    for backend in ("cuda", "torch", "cuda"):
        step, init = twb.make_whole_body_solver(params, device="cpu", backend=backend)
        state = init(11)
        for _ in range(2):
            out, state = step(state, obs)
        results.append(N(out.u_seq))
        assert state.step == 2
    np.testing.assert_allclose(results[0], results[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(results[0], results[2])


def test_low_k_guard_and_backend_checks():
    params = to_port(small(jwb.WholeBodyMPPIParams()))
    with pytest.warns(UserWarning, match="below the validated floor"):
        twb.make_whole_body_solver(params, device="cpu")
    with pytest.raises(ValueError, match="validated floor"):
        twb.make_whole_body_solver(params, device="cpu", low_k_guard="error")
    with pytest.raises(ValueError, match="unknown low_k_guard"):
        twb.make_whole_body_solver(params, device="cpu", low_k_guard="loud")
    with pytest.raises(ValueError, match="unknown backend"):
        twb.make_whole_body_solver(params, device="cpu", backend="xla", low_k_guard="off")
