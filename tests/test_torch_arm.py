"""The port's arm node against the JAX package's, on the CPU.

Cases: the arm task's cost terms (``ops/costs``) at 1e-6; ``utils/
trajectory`` at 1e-6; three arm solves (``solver/arm``) on the JAX key
chain's draws at 2e-3, the whole-body step tolerance (the same FK); the
arm episode (``sim/arm_loop``): 300 phase-1 steps at 1e-4 rad on q, 20
steps started in phase 2 at 1e-3, and the phase-1 solver state left as it
was; the checkpoint round trip (``utils/checkpoint``); ``run_arm_reach``.
Then the JAX package's own arm-node tests (``tests/test_arm_loop.py``) on
the port alone, from one 800-step episode.

Each JAX episode compiles once per module (module-scoped fixtures), at
K <= 64, H <= 16.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.models import kinova as jkinova
from quadrotor_manipulator_mppi_tpu.ops import costs as jcosts
from quadrotor_manipulator_mppi_tpu.sim import arm_loop as jarm_loop
from quadrotor_manipulator_mppi_tpu.solver import arm as jarm
from quadrotor_manipulator_mppi_tpu.solver.mppi import MPPIConfig as JMPPIConfig
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu.utils import trajectory as jtraj
from quadrotor_manipulator_mppi_tpu.utils.pose import Pose as JPose
from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models import kinova
from quadrotor_manipulator_mppi_tpu_torch.ops import costs
from quadrotor_manipulator_mppi_tpu_torch.scenarios.solvers import run_arm_reach
from quadrotor_manipulator_mppi_tpu_torch.sim import arm_loop
from quadrotor_manipulator_mppi_tpu_torch.solver import arm
from quadrotor_manipulator_mppi_tpu_torch.utils import checkpoint, trajectory
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

from torch_parity import N, T, shared_z, torch_one_thread  # noqa: F401

TOL_COST = 1e-6     # relative to the largest entry
TOL_TRAJ = 1e-6
TOL_SOLVE = 2e-3    # the whole-body step tolerance
TOL_PHASE1 = 1e-4   # rad on q over 300 phase-1 steps
TOL_PHASE2 = 1e-3   # rad on q over 20 phase-2 steps
CFG = dict(torque_limit_scale=10.0)  # the JAX arm-loop tests' configuration


def close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(N(got), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def jax_params(k=64, h=16):
    return jarm.ArmMPPIParams(mppi=JMPPIConfig(n_samples=k, n_horizon=h, n_action=7, dt=0.01,
                                               lam=0.1, sigma=0.1, savgol_window=9))


def port_params(jp):
    return convert.arm_params_from_dict(jcfg.to_dict(jp))


# ---------------------------------------------------------------------------
# The arm task's costs
# ---------------------------------------------------------------------------

def _cost_inputs(seed=0, k=16, h=10):
    rng = np.random.default_rng(seed)
    q = (jkinova.Q_HOME + 0.3 * rng.normal(size=(k, h, 7))).astype(np.float32)
    v = rng.normal(size=(k, h, 7)).astype(np.float32)
    u = rng.normal(size=(h, 7)).astype(np.float32)
    quat = rng.normal(size=(k, h, 4))
    quat = (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(np.float32)
    pos = rng.normal(size=(k, h, 3)).astype(np.float32)
    tq = rng.normal(size=4)
    tq = (tq / np.linalg.norm(tq)).astype(np.float32)
    return q, v, u, quat, pos, tq, np.array([0.1, 0.4, 1.6], np.float32)


def test_orientation_cost_defaults_agree_with_jax():
    """The port's pose costs default to the JAX package's orientation error
    (the ZYX euler norm of the reference), not the geodesic one."""
    for name in ("orientation_error_norm", "orientation_error_norm_quat", "pose_stage_cost_pq",
                 "pose_terminal_cost_pq", "pose_stage_cost", "pose_terminal_cost"):
        want = {k: p.default for k, p in inspect.signature(getattr(jcosts, name)).parameters.items()
                if p.default is not inspect.Parameter.empty}
        got = {k: p.default for k, p in inspect.signature(getattr(costs, name)).parameters.items()
               if p.default is not inspect.Parameter.empty}
        assert got == want, name
    q, _, _, quat, pos, tq, tp = _cost_inputs()
    close(costs.pose_stage_cost_pq(T(pos), T(quat), T(tp), T(tq), 50.0, 30.0),
          jcosts.pose_stage_cost_pq(pos, quat, tp, tq, 50.0, 30.0), TOL_COST)


@pytest.mark.parametrize("mode", ["euler_zyx", "log"])
def test_arm_cost_terms_match_jax(mode):
    q, v, u, quat, pos, tq, tp = _cost_inputs(1)
    sinv = np.diag(1.0 / np.linspace(0.05, 0.3, 7)).astype(np.float32)
    qc = jkinova.Q_CENTER.astype(np.float32)
    close(costs.covariance_cost(T(u), T(v), T(sinv), 0.1, 0.1, 0.1),
          jcosts.covariance_cost(u, v, sinv, 0.1, 0.1, 0.1), TOL_COST, "covariance")
    close(costs.centering_cost(T(q), T(qc), 1.0, 0.98),
          jcosts.centering_cost(q, qc, 1.0, 0.98), TOL_COST, "centering")
    close(costs.joint_tracking_cost(T(q), T(q[0]), 2.0, 0.9),
          jcosts.joint_tracking_cost(q, q[0], 2.0, 0.9), TOL_COST, "tracking")
    rot_m = jrot.quat_to_matrix(jnp.asarray(quat))
    trot = jrot.quat_to_matrix(jnp.asarray(tq))
    close(costs.orientation_error_norm(T(rot_m), T(trot), mode),
          jcosts.orientation_error_norm(rot_m, trot, mode), TOL_COST, "orientation")
    for name in ("pose_stage_cost", "pose_terminal_cost"):
        close(getattr(costs, name)(T(pos), T(rot_m), T(tp), T(trot), 50.0, 30.0, mode),
              getattr(jcosts, name)(pos, rot_m, tp, trot, 50.0, 30.0, mode), TOL_COST, name)


def test_arm_total_cost_matches_jax_with_every_term():
    q, v, u, quat, pos, tq, tp = _cost_inputs(2)
    rot_m = np.asarray(jrot.quat_to_matrix(jnp.asarray(quat)))
    trot = np.asarray(jrot.quat_to_matrix(jnp.asarray(tq)))
    sinv = np.eye(7, dtype=np.float32) * 100.0
    lo, hi = jkinova.JOINT_LOWER.astype(np.float32), jkinova.JOINT_UPPER.astype(np.float32)
    qc = jkinova.Q_CENTER.astype(np.float32)
    jp = jcosts.ArmCostParams(covar_weight=0.1, action_weight=0.01, centering_weight=1.0,
                              joint_tracking_weight=0.5, joint_limit_weight=1.0)
    tp_ = convert.config_from_dict(jcfg.to_dict(jp))
    assert isinstance(tp_, costs.ArmCostParams)
    args = (rot_m, q, v, u, sinv, tp, trot, qc, lo, hi, q[0])
    want = jcosts.arm_total_cost(jp, 0.1, pos, *args)
    got = costs.arm_total_cost(tp_, 0.1, T(pos), *map(T, args))
    close(got, want, TOL_COST)


# ---------------------------------------------------------------------------
# utils/trajectory
# ---------------------------------------------------------------------------

def test_trajectory_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    t = np.linspace(-0.5, 3.0, 41).astype(np.float32)
    q0, q1 = rng.normal(size=7).astype(np.float32), rng.normal(size=7).astype(np.float32)
    close(trajectory.cubic_timing(T(t), 0.2, 1.5), jtraj.cubic_timing(t, 0.2, 1.5), TOL_TRAJ)
    for name in ("joint_trajectory", "joint_trajectory_velocity"):
        close(getattr(trajectory, name)(T(t), 0.2, 1.5, T(q0), T(q1)),
              getattr(jtraj, name)(t, 0.2, 1.5, q0, q1), TOL_TRAJ, name)
    a, b = rng.normal(size=(2, 4))
    qa, qb = (a / np.linalg.norm(a)).astype(np.float32), (b / np.linalg.norm(b)).astype(np.float32)
    pa, pb = rng.normal(size=(2, 3)).astype(np.float32)
    got = trajectory.se3_trajectory(T(t), 0.2, 1.5, Pose(T(pa), T(qa)), Pose(T(pb), T(qb)))
    want = jtraj.se3_trajectory(t, 0.2, 1.5, JPose(pa, qa), JPose(pb, qb))
    close(got.position, want.position, TOL_TRAJ)
    close(got.quat, want.quat, TOL_TRAJ)
    for got_x, want_x in zip(trajectory.gerono_reference(T(t + 0.6), 1.2, 0.8, 2.0),
                             jtraj.gerono_reference(t + 0.6, 1.2, 0.8, 2.0)):
        close(got_x, want_x, TOL_TRAJ)

    path = tmp_path / "waypoints.txt"
    path.write_text("1.0 0 0 1 0\n2.0 1 0 1.5 90\n1.5 1 1 2 -170\n3 0 1 1 10\n1 2")
    parsed = trajectory.read_waypoint_file(str(path))
    for got_a, want_a in zip(parsed, jtraj.read_waypoint_file(str(path))):
        np.testing.assert_array_equal(got_a, want_a)
    splines, jsplines = trajectory.waypoint_splines(*parsed), jtraj.waypoint_splines(*parsed)
    for got_a, want_a in zip(splines, jsplines):
        np.testing.assert_allclose(got_a, want_a, rtol=1e-12)
    ts = np.linspace(-1.0, 9.0, 57).astype(np.float32)
    for d in range(3):
        close(trajectory.polynomial_sample(splines[0], splines[1], T(ts), derivative=d),
              jtraj.polynomial_sample(jsplines[0], jsplines[1], ts, derivative=d), TOL_TRAJ,
              f"derivative {d}")


# ---------------------------------------------------------------------------
# solver/arm
# ---------------------------------------------------------------------------

def _arm_obs(jp_pose=None):
    q = (jkinova.Q_HOME + 0.1).astype(np.float32)
    qd = np.linspace(-0.2, 0.2, 7).astype(np.float32)
    base = np.array([0.05, -0.02, 2.1], np.float32), np.array([0.99, 0.05, -0.03, 0.1])
    bq = (base[1] / np.linalg.norm(base[1])).astype(np.float32)
    tgt = jarm.default_target()
    jobs = jarm.ArmObs(q=jnp.asarray(q), qdot=jnp.asarray(qd),
                       base_pose=JPose(jnp.asarray(base[0]), jnp.asarray(bq)), target=tgt)
    obs = arm.ArmObs(q=T(q), qdot=T(qd), base_pose=Pose(T(base[0]), T(bq)),
                     target=Pose(T(tgt.position), T(tgt.quat)))
    return jobs, obs


@pytest.mark.parametrize("k,h", [(64, 16), (100, 32)])
def test_arm_solves_match_jax(k, h):
    """Three solves on the JAX key chain's draws (the preset's shape and a
    small one)."""
    jp = jax_params(k, h)
    jstep, jinit = jarm.make_arm_solver(jp)
    step, init = arm.make_arm_solver(port_params(jp), device="cpu")
    jobs, obs = _arm_obs()
    js, s = jinit(jax.random.key(7)), init(0)
    key = js.key
    jstep = jax.jit(jstep)
    for i in range(3):
        key, z = shared_z(key, k, h, 7)
        jout, js = jstep(js, jobs)
        out, s = step(s, obs, T(z))
        for name in ("u_seq", "qdes", "vdes", "ee_target_err"):
            close(getattr(out, name), getattr(jout, name), TOL_SOLVE, f"solve {i}: {name}")
        assert bool(arm.reached(out)) == bool(jarm.reached(jout))


def test_batched_arm_solve_equals_unbatched():
    """The scenario axis: two problems in one call, each as its own solve
    under its own key."""
    p = port_params(jax_params())
    step, init = arm.make_arm_solver(p, device="cpu", n_scenarios=2)
    step1, init1 = arm.make_arm_solver(p, device="cpu")
    _, obs = _arm_obs()
    obs_b = arm.ArmObs(q=torch.stack([obs.q, obs.q + 0.05]), qdot=obs.qdot.expand(2, 7),
                       base_pose=Pose(obs.base_pose.position.expand(2, 3),
                                      obs.base_pose.quat.expand(2, 4)),
                       target=Pose(obs.target.position.expand(2, 3), obs.target.quat.expand(2, 4)))
    s = init([3, 4])
    singles = [init1(3), init1(4)]
    for _ in range(2):
        out, s = step(s, obs_b)
        for b in range(2):
            one, singles[b] = step1(singles[b], arm.ArmObs(
                q=obs_b.q[b], qdot=obs_b.qdot[b], base_pose=Pose(*(x[b] for x in obs_b.base_pose)),
                target=Pose(*(x[b] for x in obs_b.target))))
            close(out.u_seq[b], N(one.u_seq), 1e-6)
            close(out.qdes[b], N(one.qdes), 1e-6)


# ---------------------------------------------------------------------------
# sim/arm_loop against the JAX episode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def phase1_runs():
    """300 steps that never hand over (converge_ticks beyond the episode),
    K=16, H=8 (the solves are discarded): the JAX and the port episode from
    the same rest."""
    jp = jax_params(16, 8)
    cfg = dict(CFG, converge_ticks=10**6)
    _, jinit = jarm.make_arm_solver(jp)
    jrun = jarm_loop.make_arm_episode(cfg=jarm_loop.ArmLoopConfig(**cfg), params=jp,
                                      n_control_steps=300)
    jfinal, jlogs = jax.jit(jrun)(jarm_loop.init_arm_loop(jinit(jax.random.key(0))))
    tp = port_params(jp)
    _, init = arm.make_arm_solver(tp, device="cpu")
    run = arm_loop.make_arm_episode(cfg=arm_loop.ArmLoopConfig(**cfg), params=tp,
                                    n_control_steps=300, device="cpu")
    s0 = arm_loop.init_arm_loop(init(0), device="cpu")
    with torch.inference_mode():
        final, logs = run(s0)
    return (jfinal, jlogs), (s0, final, logs)


def test_arm_episode_phase1_matches_jax(phase1_runs):
    (jfinal, jlogs), (_, final, logs) = phase1_runs
    close(logs[0], jlogs[0], TOL_PHASE1, "q")
    close(logs[2], jlogs[2], TOL_PHASE1, "tau")
    assert not bool(final.phase2) and not bool(jfinal.phase2)
    assert int(final.hold_count) == int(jfinal.hold_count)
    close(final.t, jfinal.t, 1e-6)


def test_arm_phase1_leaves_the_solver_state(phase1_runs):
    """During phase 1 the solve runs and is discarded whole: the warm
    start, the sigma and the solve index are those it started with, so the
    Philox stream has not advanced at the handover."""
    _, (s0, final, _) = phase1_runs
    assert torch.equal(final.solver.u_prev, s0.solver.u_prev)
    assert torch.equal(final.solver.sigma, s0.solver.sigma)
    assert final.solver.step.tolist() == [0]


def test_arm_episode_phase2_matches_jax():
    """20 steps started in phase 2, each on the JAX key chain's draw."""
    n, jp = 20, jax_params(32, 8)
    _, jinit = jarm.make_arm_solver(jp)
    q0 = (jkinova.Q_HOME + 0.004).astype(np.float32)
    js = jarm_loop.init_arm_loop(jinit(jax.random.key(3)), q0=q0)._replace(
        phase2=jnp.ones((), jnp.bool_))
    jrun = jarm_loop.make_arm_episode(cfg=jarm_loop.ArmLoopConfig(**CFG), params=jp,
                                      n_control_steps=n)
    jfinal, jlogs = jax.jit(jrun)(js)
    key, zs = js.solver.key, []
    for _ in range(n):
        key, z = shared_z(key, 32, 8, 7)
        zs.append(z)
    tp = port_params(jp)
    _, init = arm.make_arm_solver(tp, device="cpu")
    s0 = convert.arm_loop_state_from_numpy(
        js.q, js.qdot, js.t, js.phase2, js.hold_count, js.q_start, js.t_start,
        convert.state_from_numpy(js.solver.u_prev, js.solver.sigma, 0, device="cpu"),
        device="cpu")
    run = arm_loop.make_arm_episode(cfg=arm_loop.ArmLoopConfig(**CFG), params=tp,
                                    n_control_steps=n, device="cpu")
    final, logs = run(s0, z=T(np.stack(zs)))
    close(logs[0], jlogs[0], TOL_PHASE2, "q")
    close(logs[1], jlogs[1], TOL_PHASE2, "ee_err")
    close(final.solver.u_prev, jfinal.solver.u_prev, TOL_SOLVE, "u_prev")
    assert final.solver.step.tolist() == [n]


def test_checkpoint_round_trip(tmp_path):
    """A solver state and an arm-loop state saved and restored: every
    tensor bit-equal, the seed and solve index kept, and the next solves
    of the restored state equal to the uninterrupted ones."""
    p = port_params(jax_params())
    step, init = arm.make_arm_solver(p, device="cpu")
    _, obs = _arm_obs()
    _, s1 = step(init(2**63 + 5), obs)
    path = str(tmp_path / "solver.npz")
    checkpoint.save(path, s1)
    back = checkpoint.restore(path, init(0))
    assert back.seed == s1.seed and back.step == 1
    assert torch.equal(back.u_prev, s1.u_prev) and torch.equal(back.sigma, s1.sigma)
    for _ in range(3):
        (oa, s1), (ob, back) = step(s1, obs), step(back, obs)
        assert torch.equal(oa.u_seq, ob.u_seq)

    loop = arm_loop.init_arm_loop(init(9), device="cpu")
    loop = loop._replace(solver=loop.solver._replace(seed=torch.tensor([-3]),
                                                     step=torch.tensor([12])))
    checkpoint.save(str(tmp_path / "loop.npz"), loop)
    back = checkpoint.restore(str(tmp_path / "loop.npz"), arm_loop.init_arm_loop(
        init(0), device="cpu"))
    for name, a, b in zip(("q", "qdot", "t", "phase2", "hold_count", "q_start", "t_start"),
                          loop, back):
        assert torch.equal(a, b) and a.dtype == b.dtype, name
    assert back.solver.seed.tolist() == [-3] and back.solver.step.tolist() == [12]


def test_run_arm_reach_on_the_cpu():
    """The scenario's entry point: its metrics, of the JAX scenario's keys,
    on a short episode (phase 1 only: the handover needs ~2.2 s)."""
    r = run_arm_reach(seed=1, steps=12, device="cpu")
    assert set(r) == {"phase2", "min_ee_err_m", "final_ee_err_m"}
    assert r["phase2"] is False and np.isfinite(r["min_ee_err_m"])


# ---------------------------------------------------------------------------
# The JAX package's arm-node tests (tests/test_arm_loop.py) on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def long_episode():
    """One 800-step episode at K=64, H=16, the torque limits x10: the JAX
    tests' 300- and 800-step runs are its first 300 and all 800 steps."""
    p = port_params(jax_params())
    _, init = arm.make_arm_solver(p, device="cpu")
    run = arm_loop.make_arm_episode(cfg=arm_loop.ArmLoopConfig(**CFG), params=p,
                                    n_control_steps=800, device="cpu")
    with torch.inference_mode():
        return run(arm_loop.init_arm_loop(init(0), device="cpu"))


def test_phase1_reaches_home_and_hands_over(long_episode):
    """Computed-torque PD on the arm's dynamics reaches Q_HOME, and MPPI
    takes over after the 50-tick hold (the JAX test's 300-step run)."""
    final, (q_log, _, tau_log) = long_episode
    assert np.linalg.norm(N(q_log[220]) - kinova.Q_HOME) < 0.05, q_log[220]
    assert bool(final.phase2), "never handed over to MPPI"
    assert int(final.solver.step) > 500  # engaged before step 300
    assert bool(torch.isfinite(tau_log[:300]).all())


def test_phase2_mppi_reduces_ee_error(long_episode):
    _, (_, err_log, _) = long_episode
    err = N(err_log)
    assert err[300:].min() < err[250] * 0.7, (
        f"no MPPI progress: {err[250]:.3f} -> min {err[300:].min():.3f}")


def test_checkpoint_roundtrip_continues_the_stream(tmp_path):
    """The JAX test: one solve, save, restore into a fresh state, and the
    next solves of both agree exactly."""
    p = port_params(jax_params())
    step, init = arm.make_arm_solver(p, device="cpu")
    obs = arm.ArmObs(q=torch.tensor(kinova.Q_HOME, dtype=torch.float32), qdot=torch.zeros(7),
                     base_pose=arm.default_target(), target=arm.default_target())
    _, s1 = step(init(5), obs)
    path = str(tmp_path / "solver.npz")
    checkpoint.save(path, s1)
    restored = checkpoint.restore(path, init(0))
    assert torch.equal(restored.u_prev, s1.u_prev)
    out_a, _ = step(s1, obs)
    out_b, _ = step(restored, obs)
    assert torch.equal(out_a.u_seq, out_b.u_seq)
