"""The port's drone MPPI path against the JAX package on the CPU.

Inputs are made with numpy from a seed; the solvers' noise is shared by
reproducing the JAX key chain (``torch_parity.shared_z``) or by handing both
sides the same sigma-scaled noise.  Cases: the position costs and the
point-mass step; ``make_drone_solver`` against the JAX preset; the kernel
solve ``solve_drone_cuda`` (plain versions here) against
``solve_drone_pallas`` in interpret mode and the XLA pipeline; its closed
loop; the flight controllers; the drone episode ``make_episode``; the
metrics; ``convert``; and the build hash over the shared CUDA header.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.evaluation import metrics as jmetrics
from quadrotor_manipulator_mppi_tpu.models import multirotor as jmr
from quadrotor_manipulator_mppi_tpu.models import point_mass as jpm
from quadrotor_manipulator_mppi_tpu.ops import costs as jcosts
from quadrotor_manipulator_mppi_tpu.ops import integrators as jint
from quadrotor_manipulator_mppi_tpu.ops import weights as jweights
from quadrotor_manipulator_mppi_tpu.ops.pallas import drone_kernel as jdk
from quadrotor_manipulator_mppi_tpu.sim import closed_loop as jcl
from quadrotor_manipulator_mppi_tpu.sim import flight_control as jfc
from quadrotor_manipulator_mppi_tpu.solver import drone as jdrone
from quadrotor_manipulator_mppi_tpu.solver import mppi as jmppi
from quadrotor_manipulator_mppi_tpu.utils import savgol as jsavgol
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.evaluation import metrics
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr
from quadrotor_manipulator_mppi_tpu_torch.models import point_mass as pm
from quadrotor_manipulator_mppi_tpu_torch.ops import costs, sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import build
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import drone_kernel as dk
from quadrotor_manipulator_mppi_tpu_torch.parallel import sharded
from quadrotor_manipulator_mppi_tpu_torch.sim import closed_loop as cl
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
from quadrotor_manipulator_mppi_tpu_torch.solver import drone, mppi

from torch_parity import N, T, shared_z, torch_one_thread  # noqa: F401

H, A = 32, 3
X0, V0 = (0.1, -0.2, 1.0), (0.0, 0.3, 0.0)
TOL_STEP = 2e-4      # the Pallas-vs-XLA tolerance of tests/test_pallas_kernel.py
TOL_COST = 1e-4      # S relative to max(1, max|S|): cumsum vs triangular matmul
TOL_UPDATE = 1e-5    # du relative to max|du| on the same weights: order only


def _jax_params(k=256, **mppi_kw):
    base = jdrone.DroneMPPIParams()
    return dataclasses.replace(base, mppi=dataclasses.replace(base.mppi, n_samples=k, **mppi_kw))


def _port_params(jp):
    return convert.drone_params_from_dict(jcfg.to_dict(jp))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# 1. Costs and the point-mass plant
# ---------------------------------------------------------------------------

def test_position_costs_and_point_mass_step_match_jax(rng):
    traj = rng.normal(size=(5, 7, H, A)).astype(np.float32)
    target = rng.normal(size=A).astype(np.float32)
    for port_fn, jax_fn, w in ((costs.position_stage_cost, jcosts.position_stage_cost, 100.0),
                               (costs.position_terminal_cost, jcosts.position_terminal_cost, 20.0)):
        np.testing.assert_allclose(N(port_fn(T(traj), T(target), w)),
                                   np.asarray(jax_fn(traj, target, w)), rtol=1e-6)
    pos, vel, acc = (rng.normal(size=(4, A)).astype(np.float32) for _ in range(3))
    got = pm.step(pm.PointMassState(T(pos), T(vel)), T(acc), 0.01)
    want = jpm.step(jpm.PointMassState(pos, vel), acc, 0.01)
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# 2. The preset against the JAX preset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True])
def test_make_drone_solver_matches_jax(adaptive):
    """Three steps with the JAX key chain's draws; the adaptive-sigma
    configuration is ``tests/test_solver_golden.py``'s."""
    jp = _jax_params(adaptive_sigma=True, adapt_beta=0.2) if adaptive else _jax_params()
    jstep, jinit = jdrone.make_drone_solver(jp)
    jstep = jax.jit(jstep)
    step, init = drone.make_drone_solver(_port_params(jp), device="cpu")
    target = np.asarray(drone.DEFAULT_TARGET, np.float32)
    jobs = jdrone.DroneObs(x=jnp.asarray(X0), v=jnp.asarray(V0), target=jnp.asarray(target))
    obs = drone.DroneObs(x=T(X0), v=T(V0), target=T(target))
    js, st = jinit(jax.random.key(4)), init(4)
    key = js.key
    for _ in range(3):
        key, z = shared_z(key, 256, H, a=A)
        jout, js = jstep(js, jobs)
        out, st = step(st, obs, z)
        for got, want in ((out.u_seq, jout.u_seq), (st.u_prev, js.u_prev), (out.xdes, jout.xdes),
                          (out.vdes, jout.vdes)):
            np.testing.assert_allclose(N(got), np.asarray(want), rtol=TOL_STEP, atol=TOL_STEP)
        np.testing.assert_allclose(N(st.sigma), np.asarray(js.sigma), rtol=2e-3, atol=2e-3)
    if adaptive:
        assert np.abs(N(st.sigma) - 30.0).max() > 1e-3  # it moved


@pytest.mark.parametrize("sigma", [30.0, (1.0, 2.0, 3.0)])
def test_init_state_matches_jax(sigma):
    jcfg_ = jmppi.MPPIConfig(n_samples=64, n_horizon=H, n_action=A, sigma=sigma)
    js = jmppi.init_state(jcfg_, jax.random.key(0))
    st = mppi.init_state(mppi.MPPIConfig(n_samples=64, n_horizon=H, n_action=A, sigma=sigma),
                         9, device="cpu")
    np.testing.assert_allclose(N(st.u_prev), np.asarray(js.u_prev), rtol=1e-7)
    np.testing.assert_allclose(N(st.sigma), np.asarray(js.sigma), rtol=1e-7)
    assert (st.seed, st.step) == (9, 0)


# ---------------------------------------------------------------------------
# 2b. The scenario axis: B problems per call, as jax.vmap of the JAX step
# ---------------------------------------------------------------------------

B = 3


def _scenario_obs(rng):
    x = (np.asarray(X0, np.float32) + rng.normal(scale=0.3, size=(B, A))).astype(np.float32)
    v = (np.asarray(V0, np.float32) + rng.normal(scale=0.2, size=(B, A))).astype(np.float32)
    target = np.tile(np.asarray(drone.DEFAULT_TARGET, np.float32), (B, 1))
    target[1] += 0.5
    return x, v, target


@pytest.mark.parametrize("adaptive", [False, True])
def test_batched_drone_solver_matches_jax_vmap(rng, adaptive):
    """B=3 scenarios with their own observations and key chains, three
    steps, each scenario's normals from its own JAX key (``shared_z``)."""
    jp = _jax_params(adaptive_sigma=True, adapt_beta=0.2) if adaptive else _jax_params()
    jstep, jinit = jdrone.make_drone_solver(jp)
    jstep = jax.jit(jax.vmap(jstep))
    step, init = drone.make_drone_solver(_port_params(jp), device="cpu", n_scenarios=B)
    x, v, target = _scenario_obs(rng)
    jobs = jdrone.DroneObs(x=jnp.asarray(x), v=jnp.asarray(v), target=jnp.asarray(target))
    obs = drone.DroneObs(x=T(x), v=T(v), target=T(target))
    js = jax.vmap(jinit)(jax.random.split(jax.random.key(6), B))
    st = init(6)
    assert st.u_prev.shape == (B, H, A) and st.seed.shape == (B,)
    keys = [js.key[b] for b in range(B)]
    for _ in range(3):
        zs = []
        for b in range(B):
            keys[b], z = shared_z(keys[b], 256, H, a=A)
            zs.append(z)
        jout, js = jstep(js, jobs)
        out, st = step(st, obs, np.stack(zs))
        for got, want in ((out.u_seq, jout.u_seq), (st.u_prev, js.u_prev), (out.xdes, jout.xdes),
                          (out.vdes, jout.vdes)):
            assert got.shape == want.shape
            np.testing.assert_allclose(N(got), np.asarray(want), rtol=TOL_STEP, atol=TOL_STEP)
        np.testing.assert_allclose(N(st.sigma), np.asarray(js.sigma), rtol=2e-3, atol=2e-3)
    assert st.step == 3
    if adaptive:
        assert np.abs(N(st.sigma) - 30.0).max() > 1e-3  # it moved


@pytest.mark.parametrize("adaptive", [False, True])
def test_batched_philox_solve_equals_unbatched_solves(rng, adaptive):
    """Each scenario of a batched solve on the Philox stream equals the
    unbatched solve under its key, over three steps, to 1e-6 relative."""
    jp = _jax_params(k=128, adaptive_sigma=adaptive)
    params = _port_params(jp)
    step, init = drone.make_drone_solver(params, device="cpu", n_scenarios=B)
    step1, init1 = drone.make_drone_solver(params, device="cpu")
    x, v, target = _scenario_obs(rng)
    st = init(17)
    singles = [init1(seed) for seed in sampling.key_list(st.seed)]
    for _ in range(3):
        out, st = step(st, drone.DroneObs(x=T(x), v=T(v), target=T(target)))
        for b in range(B):
            one, singles[b] = step1(singles[b], drone.DroneObs(x=T(x[b]), v=T(v[b]),
                                                                 target=T(target[b])))
            assert _rel(N(out.u_seq[b]), N(one.u_seq)) <= 1e-6
            assert _rel(N(out.xdes[b]), N(one.xdes)) <= 1e-6
            assert _rel(N(st.sigma[b]), N(singles[b].sigma)) <= 1e-6


def test_batched_philox_draw_equals_unbatched_draws():
    """philox_normals under a (B,) key tensor: scenario b is bit-equal to
    the draw under key b as an int, at a global sample offset too; keys
    with the top bit set included."""
    seeds = [3, 2**40 + 7, 2**63 + 11, 2**64 - 1]
    keys = torch.tensor([s - 2**64 if s >> 63 else s for s in seeds], dtype=torch.int64)
    assert sampling.key_list(keys) == seeds
    z = sampling.philox_normals(keys, 5, 40, 7, A, sample_offset=96)
    assert z.shape == (len(seeds), A, 7, 40)
    for b, seed in enumerate(seeds):
        assert torch.equal(z[b], sampling.philox_normals(seed, 5, 40, 7, A, sample_offset=96))


def test_batched_init_spreads_scenario_seeds():
    step, init = drone.make_drone_solver(device="cpu", n_scenarios=B)
    st = init(4)
    assert sampling.key_list(st.seed) == sharded.scenario_seeds(4, B)
    assert st.sigma.shape == (B, A) and st.step == 0
    assert sampling.key_list(init([5, 6, 7]).seed) == [5, 6, 7]
    with pytest.raises(ValueError, match="2 seeds for 3 scenarios"):
        init([5, 6])


@pytest.mark.parametrize("case", ["unbatched state", "other batch", "int seed"])
def test_batched_drone_solver_refuses_a_state_of_another_batch(case):
    """A step built for B scenarios refuses a state whose leading axis is
    not B (an unbatched state, another batch size, an int key)."""
    step, init = drone.make_drone_solver(device="cpu", n_scenarios=B)
    obs = drone.DroneObs(x=torch.zeros(B, A), v=torch.zeros(B, A),
                         target=torch.zeros(B, A))
    state = {"unbatched state": drone.make_drone_solver(device="cpu")[1](0),
             "other batch": drone.make_drone_solver(device="cpu", n_scenarios=B + 1)[1](0),
             "int seed": init(0)._replace(seed=3)}[case]
    with pytest.raises(ValueError, match=f"a step built for {B} scenarios"):
        step(state, obs)


# ---------------------------------------------------------------------------
# 3-5. The kernel solve (plain versions on the CPU)
# ---------------------------------------------------------------------------

def _problem(rng, k=256):
    u_prev = rng.normal(size=(H, A)).astype(np.float32)
    noise = (rng.normal(size=(k, H, A)) * 30.0).astype(np.float32)
    return u_prev, noise, np.asarray(X0, np.float32), np.asarray(V0, np.float32), \
        np.asarray(drone.DEFAULT_TARGET, np.float32)


def _xla_solve(u_prev, noise, x0, v0, target, dt=0.01, lam=0.1):
    """The XLA pipeline of tests/test_pallas_kernel.py."""
    v = u_prev[None] + noise
    traj, _ = jint.double_integrate(v, x0, v0, dt)
    s = jcosts.position_stage_cost(traj, target, 100.0)
    s = s + jcosts.position_terminal_cost(traj, target, 20.0)
    w = jweights.softmin_weights(s, lam)
    du = jweights.weighted_noise_average(w, noise)
    return u_prev + jsavgol.smooth(du, 5, 2)


def _pallas_solve(u_prev, noise, x0, v0, target):
    return jdk.solve_drone_pallas(jnp.asarray(u_prev), jnp.asarray(x0), jnp.asarray(v0),
                                  jnp.asarray(target), jnp.asarray(0, jnp.int32),
                                  noise=jnp.asarray(noise), n_samples=noise.shape[0],
                                  n_horizon=H, n_action=A, interpret=True)


def _port_solve(u_prev, noise, x0, v0, target):
    return dk.solve_drone_cuda(T(u_prev), T(x0), T(v0), T(target), 0, noise=T(noise),
                               n_samples=noise.shape[0])


def test_kernel_solve_matches_pallas_and_xla(rng):
    prob = _problem(rng)
    got = N(_port_solve(*prob))
    np.testing.assert_allclose(got, np.asarray(_pallas_solve(*prob)), rtol=TOL_STEP,
                               atol=TOL_STEP)
    np.testing.assert_allclose(got, np.asarray(_xla_solve(*prob)), rtol=TOL_STEP, atol=TOL_STEP)


def test_plain_passes_match_the_pallas_math(rng):
    """S of pass 1 against the Pallas kernels' ``_rollout_errsq`` summed
    with the stage/terminal weights, and pass 2 against their weighted sum
    over the samples, on the same weights."""
    u_prev, noise, x0, v0, target = _problem(rng)
    k = noise.shape[0]
    lmat, lstrict = jdk._tri_matrices(H, A)
    noise_t = noise.reshape(k, H * A).T
    errsq = jdk._rollout_errsq(u_prev.reshape(H * A, 1), noise_t, lmat, lstrict,
                               np.tile(x0, H).reshape(-1, 1), np.tile(v0, H).reshape(-1, 1),
                               np.tile(target, H).reshape(-1, 1), 0.01, H, A)
    wt = np.repeat(np.r_[np.full(H - 1, 100.0), 20.0], A).reshape(-1, 1)
    s_jax = np.asarray(jnp.sum(errsq * wt, axis=0))
    s = dk.drone_cost_noise(T(u_prev), T(noise), T(x0), T(v0), T(target), 0.01, 100.0, 20.0)
    assert _rel(N(s), s_jax) <= TOL_COST
    w = np.asarray(jweights.softmin_weights(jnp.asarray(s_jax), 0.1))
    du = dk.drone_update_noise(T(noise), T(w))
    du_jax = np.asarray(jnp.sum(noise_t * w, axis=1)).reshape(H, A)
    assert np.abs(N(du) - du_jax).max() <= TOL_UPDATE * np.abs(du_jax).max()


def test_kernel_solve_equals_the_presets_first_step():
    """Without noise the kernel solve draws the preset's Philox stream: at
    the reference size K=1000 (not a multiple of 128) it equals the first
    step of make_drone_solver on the same seed."""
    step, init = drone.make_drone_solver(device="cpu")
    obs = drone.DroneObs(x=T(X0), v=T(V0), target=T(drone.DEFAULT_TARGET))
    state = init(21)
    out, _ = step(state, obs)
    counts = [f.launches for f in dk.KERNEL_WRAPPERS]
    u = dk.solve_drone_cuda(state.u_prev, obs.x, obs.v, obs.target, 21, n_samples=1000)
    assert [f.launches for f in dk.KERNEL_WRAPPERS] == counts  # plain versions on the CPU
    assert u.shape == (H, A)
    assert _rel(N(u), N(out.u_seq)) <= 1e-5
    # the seed as a (1,) int64 tensor draws the same
    u_t = dk.solve_drone_cuda(state.u_prev, obs.x, obs.v, obs.target,
                              torch.tensor([21], dtype=torch.int64), n_samples=1000)
    assert torch.equal(u_t, u)


def test_philox_passes_draw_the_plain_stream():
    keys = sampling.philox_keys(2**40 + 7, "cpu")
    noise = dk.philox_noise(keys, 96, H, A, 30.0)
    z = sampling.philox_normals(2**40 + 7, 0, 96, H, A)
    torch.testing.assert_close(noise, z.permute(2, 1, 0) * 30.0, rtol=0, atol=0)
    u_prev, x0, v0, tgt = torch.zeros(H, A), T(X0), T(V0), T(drone.DEFAULT_TARGET)
    s = dk.drone_cost(u_prev, x0, v0, tgt, keys, 96, 0.01, 30.0, 100.0, 20.0)
    torch.testing.assert_close(s, dk.drone_cost_noise(u_prev, noise, x0, v0, tgt, 0.01, 100.0,
                                                      20.0))
    w = torch.softmax(-s / 0.1, dim=0)
    torch.testing.assert_close(dk.drone_update(w, keys, H, A, 30.0),
                               dk.drone_update_noise(noise, w))


def test_kernel_wrappers_check_their_inputs():
    u_prev, x0 = torch.zeros(H, A), torch.zeros(A)
    with pytest.raises(ValueError, match="seeds"):
        dk.drone_cost(u_prev, x0, x0, x0, torch.zeros(2, dtype=torch.int64), 8, 0.01, 30.0,
                      100.0, 20.0)
    with pytest.raises(ValueError, match="x0"):
        dk.drone_cost_noise(u_prev, torch.zeros(8, H, A), torch.zeros(4), x0, x0, 0.01, 1.0, 1.0)
    with pytest.raises(ValueError, match="noise"):
        dk.drone_update_noise(torch.zeros(8, H * A), torch.zeros(8))
    with pytest.raises(ValueError, match="n_horizon, n_action"):
        dk.solve_drone_cuda(u_prev, x0, x0, x0, 0, n_horizon=16)
    with pytest.raises(ValueError, match="n_samples, n_horizon, n_action"):
        dk.solve_drone_cuda(u_prev, x0, x0, x0, 0, noise=torch.zeros(8, H, A), n_samples=16)


def _point_mass_loop(solve, noises, target):
    """Kernel-solve closed loop of tests/test_pallas_kernel.py: per step one
    solve on the given noise, then the point-mass plant on u[0]."""
    u = np.zeros((H, A), np.float32)
    pos, vel = np.zeros(A, np.float32), np.zeros(A, np.float32)
    states = []
    for noise in noises:
        u = np.asarray(solve(u, noise, pos, vel, target))
        nxt = jpm.step(jpm.PointMassState(pos, vel), u[0], 0.01)
        pos, vel = np.asarray(nxt.pos), np.asarray(nxt.vel)
        states.append(np.concatenate([pos, vel]))
    return np.stack(states)


def test_kernel_solve_closed_loop_matches_pallas_loop(rng):
    target = np.asarray(drone.DEFAULT_TARGET, np.float32)
    noises = [(rng.normal(size=(256, H, A)) * 30.0).astype(np.float32) for _ in range(5)]
    got = _point_mass_loop(lambda *a: N(_port_solve(*a)), noises, target)
    want = _point_mass_loop(_pallas_solve, noises, target)
    np.testing.assert_allclose(got, want, rtol=TOL_STEP, atol=TOL_STEP)


def test_kernel_solve_closed_loop_reaches_waypoint():
    """The gate of tests/test_pallas_kernel.py on the port alone: 80 steps
    of the explicit-noise solve close 40% of the distance, with the plant
    stepped by the port's point-mass model."""
    gen = torch.Generator().manual_seed(3)
    target = T(drone.DEFAULT_TARGET)
    u, st, errs = torch.zeros(H, A), pm.PointMassState(torch.zeros(A), torch.zeros(A)), []
    for _ in range(80):
        noise = torch.randn((256, H, A), generator=gen) * 30.0
        u = dk.solve_drone_cuda(u, st.pos, st.vel, target, 0, noise=noise, n_samples=256)
        st = pm.step(st, u[0], 0.01)
        errs.append(torch.linalg.norm(st.pos - target).item())
    assert errs[-1] < 0.6 * errs[0], f"{errs[0]:.2f} -> {errs[-1]:.2f}"


# ---------------------------------------------------------------------------
# 6. Flight control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gains", ["sim_tuned", "reference"])
def test_pid_step_and_hover_setpoint_match_jax(rng, gains):
    jg, tg = {"sim_tuned": (jfc.SIM_TUNED_GAINS, fc.SIM_TUNED_GAINS),
              "reference": (jfc.FlightGains(), fc.FlightGains())}[gains]
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    veh_j, veh_t = jmr.MultirotorParams(), mr.MultirotorParams()
    sp_pos = np.asarray([0.3, -0.4, 2.2], np.float32)
    jsp, tsp = jfc.hover_setpoint(sp_pos), fc.hover_setpoint(sp_pos, device="cpu")
    for a, b in zip(jsp, tsp):
        np.testing.assert_array_equal(N(b), np.asarray(a))
    vals = {n: rng.normal(scale=s, size=3).astype(np.float32)
            for n, s in (("pos", 0.2), ("vel", 0.3), ("rpy", 0.05), ("omega", 0.1),
                         ("tau_g", 0.5), ("int", 0.05), ("prev", 0.05))}
    vals["pos"] += np.asarray([0.0, 0.0, 2.0], np.float32)
    yaw_mom = np.float32(0.2)
    jctrl = jfc.init_ctrl_state(14.7)._replace(int_err=jnp.asarray(vals["int"]),
                                               prev_err=jnp.asarray(vals["prev"]))
    tctrl = fc.init_ctrl_state(14.7)._replace(int_err=T(vals["int"]), prev_err=T(vals["prev"]))
    for kw_j, kw_t in (({}, {}), (dict(tau_g=vals["tau_g"], yaw_mom=yaw_mom, mass=15.2),
                                  dict(tau_g=T(vals["tau_g"]), yaw_mom=T(yaw_mom), mass=15.2))):
        uj, cj = jfc.pid_step(jg, veh_j, jctrl, jsp, vals["pos"], vals["vel"], vals["rpy"],
                              vals["omega"], 0.001, **kw_j)
        ut, ct = fc.pid_step(tg, veh_t, tctrl, tsp, T(vals["pos"]), T(vals["vel"]),
                             T(vals["rpy"]), T(vals["omega"]), 0.001, **kw_t)
        np.testing.assert_allclose(N(ut), np.asarray(uj), rtol=1e-5, atol=1e-5)
        for a, b in zip(cj, ct):
            np.testing.assert_allclose(N(b), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_gain_presets_and_safeguards_match_jax():
    assert dataclasses.asdict(fc.AGGRESSIVE_GAINS) == dataclasses.asdict(jfc.AGGRESSIVE_GAINS)
    assert fc.aggressive_safeguards(mr.MultirotorParams()) == \
        jfc.aggressive_safeguards(jmr.MultirotorParams())


# ---------------------------------------------------------------------------
# 7-8. The drone episode
# ---------------------------------------------------------------------------

N_EPISODE, K_EPISODE = 20, 64
EPISODES = {"pid": ("pid", "sim_tuned"), "backstepping": ("backstepping", "reference")}


def _gains(name):
    return {"sim_tuned": (jfc.SIM_TUNED_GAINS, fc.SIM_TUNED_GAINS),
            "reference": (jfc.FlightGains(), fc.FlightGains())}[name]


@pytest.fixture(scope="module", params=sorted(EPISODES))
def episode(request):
    """(JAX logs, port logs, JAX initial state, port initial state) of a
    20-step drone waypoint episode from (0, 0, 2) with the solver's draws
    shared."""
    controller, gains = EPISODES[request.param]
    jg, tg = _gains(gains)
    jp = _jax_params(k=K_EPISODE)
    target = np.asarray(drone.DEFAULT_TARGET, np.float32)
    jcfg_loop = jcl.LoopConfig(controller=controller)
    jstep, jinit = jdrone.make_drone_solver(jp)
    jrun = jcl.make_episode(
        jcfg_loop, jmr.MultirotorParams(), jg, solver_step=jstep,
        make_obs=lambda plant: jdrone.DroneObs(x=plant.pos, v=plant.vel,
                                               target=jnp.asarray(target)),
        setpoint_of=lambda out, plant: jfc.hover_setpoint(out.xdes),
        n_control_steps=N_EPISODE)
    js0 = jcl.init_loop_state(jcfg_loop, jmr.MultirotorParams(), jinit(jax.random.key(0)),
                              pos=(0.0, 0.0, 2.0))
    _, jlogs = jax.jit(jrun)(js0)

    key, zs = js0.solver.key, []
    for _ in range(N_EPISODE):
        key, z = shared_z(key, K_EPISODE, H, a=A)
        zs.append(z)
    cfg = cl.LoopConfig(controller=controller)
    step, init = drone.make_drone_solver(_port_params(jp), device="cpu")
    run = cl.make_episode(
        cfg, mr.MultirotorParams(), tg, solver_step=step,
        make_obs=lambda plant: drone.DroneObs(x=plant.pos, v=plant.vel, target=T(target)),
        setpoint_of=lambda out, plant: fc.hover_setpoint(out.xdes),
        n_control_steps=N_EPISODE)
    ts0 = cl.init_loop_state(cfg, mr.MultirotorParams(), init(0), pos=(0.0, 0.0, 2.0),
                             device="cpu")
    final, logs = run(ts0, z=T(np.stack(zs)))
    return request.param, jlogs, logs, js0, ts0, final


def test_episode_matches_jax(episode):
    name, jlogs, logs, _, _, final = episode
    for label, got, want in zip(("pos", "rpy", "vel"), logs, jlogs):
        assert got.shape == (N_EPISODE, 3)
        np.testing.assert_allclose(N(got), np.asarray(want), atol=5e-3,
                                   err_msg=f"{name}: {label}")
    assert final.solver.step == N_EPISODE


def test_init_loop_state_matches_jax(episode):
    _, _, _, js0, ts0, _ = episode
    for a, b in ((js0.plant, ts0.plant), (js0.ctrl, ts0.ctrl), (js0.setpoint, ts0.setpoint)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(N(y), np.asarray(x), rtol=1e-7)


def test_null_solver_hover_passes_hover_metrics():
    """The inner loop alone holds a hover within the reference's thresholds
    (400 control steps, as tests/test_sim.py)."""
    cfg = cl.LoopConfig(controller="backstepping")
    target = torch.tensor([0.0, 0.0, 2.0])
    run = cl.make_episode(cfg, mr.MultirotorParams(), fc.FlightGains(),
                          solver_step=lambda state, obs: (None, state),
                          make_obs=lambda plant: None,
                          setpoint_of=lambda out, plant: fc.hover_setpoint(target),
                          n_control_steps=400)
    _, (pos, _, _) = run(cl.init_loop_state(cfg, mr.MultirotorParams(), None,
                                            pos=(0.0, 0.0, 2.0), device="cpu"))
    m = metrics.hover_metrics(pos, torch.zeros_like(pos), target, dt=0.01)
    assert bool(m.passed), f"pos_rms {float(m.pos_rms):.3f}"
    assert float(m.pos_rms) < 0.05


def test_make_episode_checks():
    with pytest.raises(ValueError, match="unknown controller"):
        cl.make_episode(cl.LoopConfig(controller="lqr"), mr.MultirotorParams(), fc.FlightGains(),
                        None, None, None, 5)
    cfg = cl.LoopConfig()
    run = cl.make_episode(cfg, mr.MultirotorParams(), fc.FlightGains(), None, None, None, 5)
    with pytest.raises(ValueError, match="z carries 3 steps, the episode 5"):
        run(None, z=torch.zeros(3, 8, H, A))


# ---------------------------------------------------------------------------
# 9. Metrics
# ---------------------------------------------------------------------------

def test_metrics_match_jax(rng):
    steps = rng.normal(scale=0.02, size=(2, 300, 3)).astype(np.float32)
    pos = np.cumsum(steps, axis=1) + np.asarray([0.0, 0.0, 2.0], np.float32)
    rate = rng.normal(scale=0.1, size=(2, 300, 3)).astype(np.float32)
    target = np.asarray([0.05, -0.05, 2.0], np.float32)
    pairs = [
        (metrics.rms(T(rate)), jmetrics.rms(rate)),
        (metrics.rms(T(rate), axis=-1), jmetrics.rms(rate, axis=-1)),
        (metrics.position_rms_error(T(pos), T(target)), jmetrics.position_rms_error(pos, target)),
        (metrics.tracking_rmse(T(pos), T(pos[::-1].copy())),
         jmetrics.tracking_rmse(pos, pos[::-1])),
    ]
    for radius in (0.1, 0.3, 5.0):
        pairs += [(metrics.settling_time(T(pos), T(target), 0.01, radius),
                   jmetrics.settling_time(pos, target, 0.01, radius)),
                  (metrics.waypoint_response(T(pos), T(target), 0.01, radius),
                   jmetrics.waypoint_response(pos, target, 0.01, radius))]
    pairs += list(zip(metrics.hover_metrics(T(pos), T(rate), T(target), 0.01),
                      jmetrics.hover_metrics(pos, rate, target, 0.01)))
    pairs += list(zip(metrics.hover_metrics(T(pos), T(rate * 0.1), T(target), 0.01, 0.25),
                      jmetrics.hover_metrics(pos, rate * 0.1, target, 0.01, 0.25)))
    for got, want in pairs:
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert (metrics.HOVER_POS_RMS_THRESHOLD, metrics.HOVER_ANG_RATE_THRESHOLD) == \
        (jmetrics.HOVER_POS_RMS_THRESHOLD, jmetrics.HOVER_ANG_RATE_THRESHOLD)


# ---------------------------------------------------------------------------
# 10. convert, the build hash, and the card default
# ---------------------------------------------------------------------------

def test_drone_params_and_loop_config_cross_from_jax():
    jp = jdrone.DroneMPPIParams(
        mppi=jmppi.MPPIConfig(n_samples=512, n_horizon=24, n_action=3, dt=0.02, lam=0.3,
                              sigma=np.asarray([10.0, 20.0, 5.0]), savgol_window=7,
                              warm_start_decay=0.9, adaptive_sigma=True),
        stage_weight=50.0, terminal_weight=35.0)
    tp = convert.drone_params_from_dict(jcfg.to_dict(jp))
    assert isinstance(tp, drone.DroneMPPIParams)
    assert (tp.stage_weight, tp.terminal_weight) == (50.0, 35.0)
    for f in dataclasses.fields(jp.mppi):
        a, b = getattr(jp.mppi, f.name), getattr(tp.mppi, f.name)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f.name)
    assert convert.drone_params_from_dict(jcfg.to_dict(jdrone.DroneMPPIParams())) == \
        drone.DroneMPPIParams()
    for loop in (jcl.LoopConfig(), jcl.LoopConfig(physics_dt=0.002, substeps=5,
                                                  controller="backstepping", extra_mass=1.5)):
        got = convert.config_from_dict(jcfg.to_dict(loop))
        assert got == cl.LoopConfig(**dataclasses.asdict(loop))
    with pytest.raises(ValueError, match="expected a DroneMPPIParams"):
        convert.drone_params_from_dict(jcfg.to_dict(jcl.LoopConfig()))


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Editing a byte of csrc/philox.cuh (in a copy) changes the build
    directory of both kernels that include it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build._build_dir(n) for n in ("whole_body_kernel", "drone_kernel")}
    assert before == {n: build._build_dir(n) for n in before}  # stable
    header = csrc / "philox.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = {n: build._build_dir(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert (csrc / "drone_kernel.cu").read_text().count('#include "philox.cuh"') == 1


@pytest.mark.parametrize("define,attr", [
    ("DRONE_COST_WARPS", "COST_WARPS"), ("WARP_LANES", "WARP_LANES"),
    ("DRONE_UPDATE_TILE", "UPDATE_TILE"), ("DRONE_UPDATE_WARPS", "UPDATE_WARPS"),
])
def test_drone_constants_match_the_cuda_source(define, attr):
    """drone_cost's warps per block and chunk length, and drone_update's
    tile width and warps per block, in the source or the scan header it
    includes, against the wrapper's."""
    import re

    text = (build.CSRC / "drone_kernel.cu").read_text() + (build.CSRC / "warp_scan.cuh").read_text()
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}
    assert defines[define] == getattr(dk, attr)


@pytest.mark.parametrize("k,h", [(1000, 32), (1024, 32), (4096, 32), (16384, 32),
                                 (16384, 100), (1, 32), (33, 5), (1000, 33), (10**6, 1)])
def test_update_split_covers_every_column_and_sample(k, h):
    """The split rule: one column per block (all K, no chunks) up to
    UPDATE_NARROW_MAX_K samples when the columns give UPDATE_NARROW_MIN_COLUMNS
    blocks; else tiles of 32 columns cover H*A and the chunks cover K, each
    a multiple of the block's warps, the last one non-empty, at most one
    chunk per UPDATE_MIN_CHUNK samples, the launch within UPDATE_BLOCKS
    blocks (one tile's worth over, at most)."""
    tile, blocks, chunks, k_chunk = dk.update_split(k, h, A)
    c = h * A
    assert tile in (1, dk.UPDATE_TILE) and blocks == -(-c // tile)
    assert k_chunk % dk.UPDATE_WARPS == 0 and (chunks - 1) * k_chunk < k <= chunks * k_chunk
    narrow = k <= dk.UPDATE_NARROW_MAX_K and c >= dk.UPDATE_NARROW_MIN_COLUMNS
    assert (tile == 1) == narrow
    if narrow:
        assert chunks == 1
    else:
        assert chunks <= -(-k // dk.UPDATE_MIN_CHUNK)
        assert chunks == 1 or blocks * chunks <= dk.UPDATE_BLOCKS + blocks
    if k >= dk.UPDATE_MIN_CHUNK * dk.UPDATE_BLOCKS:
        assert blocks * chunks > dk.UPDATE_BLOCKS // 2  # a large K fills the card


@pytest.mark.parametrize("k,h,want", [(1000, 32, 1), (1024, 32, 1), (4096, 32, 1),
                                      (16384, 32, 32), (16384, 100, 32), (1000, 5, 32)])
def test_update_split_picks_the_measured_tile(k, h, want):
    """chip_smoke's sweep shapes: one column per block at the preset and up
    to K=4096 (H=32), 32-column tiles at K=16384; few columns, wide tiles."""
    assert dk.update_split(k, h, A)[0] == want


def test_drone_c_interface_matches_the_cuda_source():
    """Argument counts of both C entry points against their ctypes
    declarations (drone_update_launch takes the tile width, the chunk
    length, the partials and the tickets)."""
    import re

    src = (build.CSRC / "drone_kernel.cu").read_text()

    def c_params(fn):
        sig = re.search(rf"int {fn}\((.*?)\)\s*\{{", src, re.S).group(1)
        return len([p for p in sig.split(",") if p.strip()])

    class Fake:
        class F:
            pass

        drone_cost_launch, drone_update_launch = F(), F()

    orig = build.load_library
    dk._lib.cache_clear()
    try:
        build.load_library = lambda name: Fake()
        lib = dk._lib()
    finally:
        build.load_library = orig
        dk._lib.cache_clear()
    assert len(lib.drone_cost_launch.argtypes) == c_params("drone_cost_launch") == 15
    assert len(lib.drone_update_launch.argtypes) == c_params("drone_update_launch") == 13


def test_build_hash_covers_the_scan_header(tmp_path, monkeypatch):
    """Editing a byte of csrc/warp_scan.cuh (in a copy) changes the build
    directory of both kernels that include it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build._build_dir(n) for n in ("whole_body_kernel", "drone_kernel")}
    path = csrc / "warp_scan.cuh"
    path.write_bytes(path.read_bytes() + b"\n")
    assert all(build._build_dir(n) != before[n] for n in before)
    assert all((csrc / f"{n}.cu").read_text().count('#include "warp_scan.cuh"') == 1
               for n in before)


@pytest.mark.parametrize("h", [1, 33, 100])
def test_drone_cost_plain_across_chunk_edges(h):
    """The plain pass 1 the kernel is held to, at one step, a partial second
    chunk and four chunks: explicit noise reproduces the drawn stream's
    costs, and each S is the weighted squared error of the double
    integration."""
    keys = sampling.philox_keys(11 + h, "cpu")
    gen = torch.Generator().manual_seed(h)
    u_prev = torch.randn(h, A, generator=gen)
    x0, v0, tgt = T(X0), T(V0), T(drone.DEFAULT_TARGET)
    s = dk.drone_cost(u_prev, x0, v0, tgt, keys, 5, 0.01, 30.0, 100.0, 20.0)
    noise = dk.philox_noise(keys, 5, h, A, 30.0)
    torch.testing.assert_close(s, dk.drone_cost_noise(u_prev, noise, x0, v0, tgt, 0.01, 100.0,
                                                      20.0), rtol=0, atol=0)
    acc = (u_prev[None] + noise).double()
    vel = v0.double() + torch.cumsum(acc * 0.01, dim=1)
    v_prev = torch.cat([v0.double().expand(5, 1, A), vel[:, :-1]], dim=1)
    pos = x0.double() + torch.cumsum(v_prev * 0.01 + 0.5 * acc * 0.01 ** 2, dim=1)
    err = ((pos - tgt.double()) ** 2).sum(-1)
    want = 100.0 * err[:, :-1].sum(-1) + 20.0 * err[:, -1]
    assert _rel(N(s), N(want)) <= TOL_COST


def test_drone_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: drone.make_drone_solver(),
                 lambda: mppi.init_state(drone.DroneMPPIParams().mppi, 0),
                 lambda: cl.init_loop_state(cl.LoopConfig(), mr.MultirotorParams(), None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
