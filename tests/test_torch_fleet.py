"""The port's fleet episode (``make_whole_body_episode(n_scenarios=B)``) and
the batched pieces under it, on the CPU.

The fleet is ``jax.vmap(run)`` of the JAX episode: B vehicles from
randomized starts (the JAX ``whole-body-batch`` scenario's draws, here
made with numpy), one batched solve and one B-row plant period per control
step.  Each case holds the batched port episode against ``jax.jit(jax.vmap
(run))`` of the JAX episode with the solver's noise shared (each
scenario's JAX key chain drawn and passed as ``z``; atol 5e-3 on the logs
and the final base position, as ``tests/test_torch_episode.py``), and
against B unbatched port episodes on the same ``z`` (atol 1e-4: the same
arithmetic batched).  The serving configuration runs the plant tick's plain
version on the port side and the XLA physics substeps on the JAX side
(reference note a of ROADMAP.md).  Also: the plain pipeline with a
scenario axis against unbatched solves and ``jax.vmap`` of the JAX XLA
step, the batched plant start, pose Jacobian and fleet starts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.parallel.sharded import scenario_keys
from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwbs
from quadrotor_manipulator_mppi_tpu.utils.pose import Pose as JPose
from quadrotor_manipulator_mppi_tpu_torch.models.whole_body import rollout
from quadrotor_manipulator_mppi_tpu_torch.parallel.multihost import tree_map
from quadrotor_manipulator_mppi_tpu_torch.parallel.sharded import scenario_seeds
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twbs
from quadrotor_manipulator_mppi_tpu_torch.solver.mppi import MPPIState
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

from torch_parity import N, T, shared_z, small, to_port, torch_one_thread  # noqa: F401

TOL_JAX = 5e-3
TOL_SINGLE = 1e-4
SERVING = dict(arm_coeffs_per_control=True, plant_kernel=True)
CASES = {
    # name: (JAX params, port loop config, JAX loop config, scenarios, control steps)
    "serving": (lambda: jwbs.position_mode_params(n_samples=64, n_horizon=8), SERVING,
                dict(arm_coeffs_per_control=True), 3, 20),
    "attitude": (lambda: small(jwbs.WholeBodyMPPIParams(), k=256, h=12), {}, {}, 2, 5),
    "wrench": (lambda: jwbs.wrench_mode_params(n_samples=256, n_horizon=12), {}, {}, 2, 5),
}


def _offsets(b, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32),
            rng.uniform(-0.15, 0.15, (b, 3)).astype(np.float32))


@pytest.fixture(scope="module", params=sorted(CASES))
def fleets(request):
    """(case, JAX (final, logs), port fleet (final, logs), the port's
    unbatched episodes [(final, logs)] per scenario)."""
    make, loop, jloop, b, n = CASES[request.param]
    jp = make()
    k, h = jp.mppi.n_samples, jp.mppi.n_horizon
    base_off, tgt_off = _offsets(b)
    jrun = jwbl.make_whole_body_episode(jp, cfg=jwbl.WholeBodyLoopConfig(**jloop),
                                        n_control_steps=n, low_k_guard="off")
    _, jinit = jwbs.make_whole_body_solver(jp, low_k_guard="off")
    jobs = jwbs.default_obs()
    jplants = jax.vmap(lambda off: jwbl.init_plant(jp.model.vehicle,
                                                   pos=jnp.asarray([0.0, 0.0, 2.1]) + off))(
        jnp.asarray(base_off))
    jsolvers = jax.vmap(jinit)(scenario_keys(jax.random.key(0), b))
    jtargets = JPose(position=jobs.ee_target.position + tgt_off,
                     quat=jnp.broadcast_to(jobs.ee_target.quat, (b, 4)))
    jbase = jobs.base_target + tgt_off
    jfinal, jlogs = jax.jit(jax.vmap(jrun))(jplants, jsolvers, jtargets, jbase)

    # Each scenario's JAX key chain, drawn as the JAX solver draws it.
    z = np.zeros((n, b, k, h, 11), np.float32)
    for s in range(b):
        key = jsolvers.key[s]
        for i in range(n):
            key, z[i, s] = shared_z(key, k, h)

    tp = to_port(jp)
    cfg = wbl.WholeBodyLoopConfig(**loop)
    run = wbl.make_whole_body_episode(tp, cfg=cfg, n_control_steps=n, low_k_guard="off",
                                      device="cpu", n_scenarios=b)
    _, init = twbs.make_whole_body_solver(tp, device="cpu", low_k_guard="off", n_scenarios=b)
    obs = twbs.default_obs(device="cpu")
    plants = wbl.init_plant(tp.model.vehicle, pos=np.asarray([0.0, 0.0, 2.1]) + base_off,
                            device="cpu")
    targets = Pose(position=obs.ee_target.position + T(tgt_off),
                   quat=obs.ee_target.quat.expand(b, 4).clone())
    base_targets = obs.base_target + T(tgt_off)
    solvers = init(0)
    fleet = run(plants, solvers, targets, base_targets, z=T(z))

    single = wbl.make_whole_body_episode(tp, cfg=cfg, n_control_steps=n, low_k_guard="off",
                                         device="cpu")
    singles = [single(tree_map(lambda x: x[s], plants),
                      MPPIState(u_prev=solvers.u_prev[s], sigma=solvers.sigma[s],
                                seed=int(solvers.seed[s]), step=0),
                      tree_map(lambda x: x[s], targets), base_targets[s], z=T(z[:, s]))
               for s in range(b)]
    return request.param, (jfinal, jlogs), fleet, singles


def test_fleet_matches_jax_vmap(fleets):
    name, (jfinal, jlogs), (final, logs), _ = fleets
    assert all(bool(torch.isfinite(f).all()) for f in logs)
    assert logs.ee_err.shape == np.asarray(jlogs.ee_err).shape  # (B, n_control_steps)
    np.testing.assert_allclose(N(logs.ee_err), np.asarray(jlogs.ee_err), atol=TOL_JAX,
                               err_msg=name)
    np.testing.assert_allclose(N(final[0].base.pos), np.asarray(jfinal[0].base.pos),
                               atol=TOL_JAX, err_msg=name)


def test_fleet_logs_agree_with_jax_vmap(fleets):
    name, (_, jlogs), (_, logs), _ = fleets
    for field in ("l1_cmd", "l1_meas", "tilt", "base_pos", "obj_pos"):
        np.testing.assert_allclose(N(getattr(logs, field)), np.asarray(getattr(jlogs, field)),
                                   atol=TOL_JAX, err_msg=f"{name}: {field}")
    np.testing.assert_allclose(N(logs.ori_err), np.asarray(jlogs.ori_err), atol=2 * TOL_JAX,
                               err_msg=f"{name}: ori_err")


def test_fleet_equals_unbatched_episodes(fleets):
    name, _, (final, logs), singles = fleets
    for s, (f1, l1) in enumerate(singles):
        for field in l1._fields:
            np.testing.assert_allclose(N(getattr(logs, field)[s]), N(getattr(l1, field)),
                                       atol=TOL_SINGLE, rtol=0, err_msg=f"{name} {s}: {field}")
        np.testing.assert_allclose(N(final[0].base.pos[s]), N(f1[0].base.pos), atol=TOL_SINGLE,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(N(final[1].u_prev[s]), N(f1[1].u_prev),
                                   atol=TOL_SINGLE * max(1.0, float(f1[1].u_prev.abs().max())),
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# The plain pipeline with a scenario axis (make_whole_body_solver, torch)
# ---------------------------------------------------------------------------

B, K, H = 3, 128, 8


def _batched_obs(obs, b=B):
    """b observations that differ in base state, arm angles and targets
    (unit target quaternions)."""
    def vary(i, x):
        return x if x.shape[-1] == 4 else x + 0.03 * i * torch.linspace(-1.0, 1.0, x.shape[-1])
    return tree_map(lambda x: torch.stack([vary(i, x) for i in range(b)]), obs)


def _assert_rel(got, want, tol=1e-6):
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("mode", ["position", "attitude", "wrench"])
def test_plain_batched_step_equals_unbatched_steps(mode):
    params = {"position": twbs.position_mode_params(K, H),
              "attitude": small(twbs.WholeBodyMPPIParams(), K, H),
              "wrench": twbs.wrench_mode_params(K, H)}[mode]
    step_b, init_b = twbs.make_whole_body_solver(params, device="cpu", backend="torch",
                                                 low_k_guard="off", n_scenarios=B)
    step_1, _ = twbs.make_whole_body_solver(params, device="cpu", backend="torch",
                                            low_k_guard="off")
    obs = _batched_obs(twbs.default_obs(device="cpu"))
    st_b = init_b(5)
    seeds = scenario_seeds(5, B)
    for _ in range(2):
        out_b, st_next = step_b(st_b, obs)  # the Philox stream, key b per scenario
        for b in range(B):
            st = MPPIState(u_prev=st_b.u_prev[b], sigma=st_b.sigma[b], seed=seeds[b],
                           step=st_b.step)
            out, st = step_1(st, tree_map(lambda x: x[b], obs))
            for got, want in zip(out_b, out):
                _assert_rel(got[b], want)
            _assert_rel(st_next.u_prev[b], st.u_prev)
        st_b = st_next
    assert st_b.step == 2


@pytest.mark.parametrize("mode", ["position", "attitude"])
def test_plain_batched_step_matches_jax_vmap(mode):
    jp = small(jwbs.position_mode_params() if mode == "position"
               else jwbs.WholeBodyMPPIParams(), k=K, h=H)
    jstep, jinit = jwbs.make_whole_body_solver(jp, low_k_guard="off")
    keys = scenario_keys(jax.random.key(4), B)
    jstates = jax.vmap(jinit)(keys)
    jobs = tree_map(lambda x: np.asarray(x), jwbs.default_obs())
    jobs = jax.tree.map(lambda x: np.stack([x * (1.0 + 0.05 * i * (x.shape[-1] != 4))
                                            for i in range(B)]), jobs)
    vstep = jax.jit(jax.vmap(jstep))
    tstep, tinit = twbs.make_whole_body_solver(to_port(jp), device="cpu", backend="torch",
                                               low_k_guard="off", n_scenarios=B)
    tstate = tinit(0)._replace(u_prev=T(jstates.u_prev), sigma=T(jstates.sigma))
    tobs = tree_map(lambda x: torch.tensor(np.asarray(x, np.float32)), jobs)
    keys_now = list(keys)
    for _ in range(2):
        zs = []
        for b in range(B):
            keys_now[b], z = shared_z(keys_now[b], K, H)
            zs.append(z)
        jout, jstates = vstep(jstates, jobs)
        tout, tstate = tstep(tstate, tobs, T(np.stack(zs)))
        np.testing.assert_allclose(N(tout.u_seq), np.asarray(jout.u_seq), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(N(tstate.u_prev), np.asarray(jstates.u_prev), rtol=2e-3,
                                   atol=2e-3)


# ---------------------------------------------------------------------------
# The batched pieces of the control step, and the fleet's starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["position", "attitude", "wrench"])
def test_rollout_batched_equals_unbatched(mode):
    """The rollouts take a leading scenario axis (the episode's carrot runs
    the position rollout over a fleet); each scenario equals its unbatched
    rollout up to a batched matmul's summation order."""
    params = {"position": twbs.position_mode_params(K, H),
              "attitude": small(twbs.WholeBodyMPPIParams(), K, H),
              "wrench": twbs.wrench_mode_params(K, H)}[mode].model
    obs = _batched_obs(twbs.default_obs(device="cpu"))
    v = T(np.random.default_rng(3).normal(size=(B, K, H, 11)) * 0.5)
    batched = torch.utils._pytree.tree_leaves(rollout(params, obs.state, v, 0.01))
    for b in range(B):
        one = rollout(params, tree_map(lambda x: x[b], obs.state), v[b], 0.01)
        for got, want in zip(batched, torch.utils._pytree.tree_leaves(one)):
            _assert_rel(got[b], want, 1e-6)


def test_init_plant_batched_equals_stacked():
    vehicle = twbs.position_mode_params().model.vehicle
    pos = np.asarray([[0.1, 0.0, 2.0], [0.0, -0.2, 2.3]])
    fleet = wbl.init_plant(vehicle, pos=pos, device="cpu")
    for b in range(2):
        one = wbl.init_plant(vehicle, pos=tuple(pos[b]), device="cpu")
        for got, want in zip(tree_map(lambda x: x[b], fleet), one):
            assert all(torch.equal(g, w) for g, w in zip(torch.utils._pytree.tree_leaves(got),
                                                          torch.utils._pytree.tree_leaves(want)))


def test_pose_error_jacobian_batched_equals_unbatched():
    rng = np.random.default_rng(2)
    spec = twbs.position_mode_params().model.chain()
    q = T(rng.uniform(1.0, 4.0, (3, 7)))
    bpos = T(rng.normal(size=(3, 3)) * 0.1 + [0, 0, 2])
    bquat = rng.normal(size=(3, 4)) * [1, 0.1, 0.1, 0.3] + [1, 0, 0, 0]
    bquat = T(bquat / np.linalg.norm(bquat, axis=-1, keepdims=True))
    tq = rng.normal(size=(3, 4))
    target = Pose(T(rng.normal(size=(3, 3)) * 0.1 + [0.3, 0.1, 1.6]),
                  T(tq / np.linalg.norm(tq, axis=-1, keepdims=True)))
    err6, jac = wbl.pose_error_jacobian(spec, q, bpos, bquat, target, 0.3)
    assert err6.shape == (3, 6) and jac.shape == (3, 6, 7)
    for b in range(3):
        e1, j1 = wbl.pose_error_jacobian(spec, q[b], bpos[b], bquat[b],
                                         tree_map(lambda x: x[b], target), 0.3)
        torch.testing.assert_close(err6[b], e1, rtol=0, atol=1e-6)
        torch.testing.assert_close(jac[b], j1, rtol=0, atol=1e-6)


def test_fleet_starts():
    params = twbs.position_mode_params(n_samples=64, n_horizon=8)
    plants, solver, targets, base_targets = wbl.fleet_starts(params, 5, seed=3, device="cpu")
    obs = twbs.default_obs(device="cpu")
    base_off = plants.base.pos - torch.tensor([0.0, 0.0, 2.1])
    tgt_off = targets.position - obs.ee_target.position
    assert plants.base.pos.shape == (5, 3) and plants.q.shape == (5, 7)
    assert base_off.abs().max() <= 0.3 and tgt_off.abs().max() <= 0.15 + 1e-6
    torch.testing.assert_close(base_targets - obs.base_target, tgt_off)  # re-stationed
    assert torch.equal(targets.quat, obs.ee_target.quat.expand(5, 4))
    assert solver.seed.tolist() == scenario_seeds(3, 5) and solver.u_prev.shape == (5, 8, 11)
    again = wbl.fleet_starts(params, 5, seed=3, device="cpu")
    assert torch.equal(again[0].base.pos, plants.base.pos)
    other = wbl.fleet_starts(params, 5, seed=4, device="cpu")
    assert not torch.equal(other[0].base.pos, plants.base.pos)


def test_fleet_rejects_a_foreign_z():
    params = twbs.position_mode_params(n_samples=64, n_horizon=8)
    run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**SERVING),
                                      n_control_steps=3, device="cpu", n_scenarios=2)
    with pytest.raises(ValueError, match="z carries 2 steps, the episode 3"):
        run(*wbl.fleet_starts(params, 2, device="cpu"), z=torch.zeros(2, 2, 64, 8, 11))
