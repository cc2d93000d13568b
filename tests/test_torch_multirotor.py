"""The port's multirotor MPPI preset and perfect-model loops against the JAX
package's, on the CPU.

Cases: three solves of ``make_multirotor_solver`` on the JAX key chain's
draws, in attitude and wrench mode (u_seq 2e-4 relative to its largest
entry); a batch of two problems against unbatched solves (1e-6); 20 steps
of the perfect-model waypoint loop against the JAX loop on the same draws
(position 1e-4 m); 10 steps of the perfect-model whole-body loop
(``whole_body_episode``, the kernels' plain versions) against the JAX
scenario's loop with the XLA step (EE error and base position 1e-3, the
whole-body step's tolerance); the configuration crossing through
``convert``.  Then the JAX package's own preset tests
(``tests/test_multirotor_mppi.py``: hover and waypoint, K=256) on the port
alone, and the scenarios' entry points on short episodes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.models import chain as jchain
from quadrotor_manipulator_mppi_tpu.models import whole_body as jwbm
from quadrotor_manipulator_mppi_tpu.models.multirotor import Multirotor12State as JState12
from quadrotor_manipulator_mppi_tpu.models.whole_body import WholeBodyState as JWBState
from quadrotor_manipulator_mppi_tpu.scenarios.solvers import _base12 as jbase12
from quadrotor_manipulator_mppi_tpu.solver import multirotor_mppi as jmm
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models.multirotor import Multirotor12State
from quadrotor_manipulator_mppi_tpu_torch.scenarios.solvers import (
    multirotor_episode, run_multirotor_waypoint, run_whole_body, whole_body_episode,
)
from quadrotor_manipulator_mppi_tpu_torch.solver import multirotor_mppi as mm

from torch_parity import N, T, shared_z, small, torch_one_thread  # noqa: F401

TOL_SOLVE = 2e-4     # u_seq, relative to its largest entry
TOL_BATCH = 1e-6     # a batched solve against unbatched ones
TOL_LOOP = 1e-4      # m, position over 20 perfect-model steps
TOL_WHOLE_BODY = 1e-3  # EE error and base position over 10 whole-body steps
WAYPOINT = (1.0, 2.0, 3.4)


def close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(N(got), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def jax_params(k=128, h=16, mode="attitude"):
    p = small(jmm.MultirotorMPPIParams(), k, h)
    return dataclasses.replace(p, model=dataclasses.replace(p.model, control_mode=mode))


def port_params(jp):
    return convert.config_from_dict(jcfg.to_dict(jp))


def _state(seed=0):
    rng = np.random.default_rng(seed)
    pos, rpy, vel, om = (rng.normal(size=3).astype(np.float32) * s for s in (1.0, 0.1, 0.5, 0.2))
    pos[2] += 2.0
    return (JState12(*map(jnp.asarray, (pos, rpy, vel, om))),
            Multirotor12State(*map(T, (pos, rpy, vel, om))))


def test_params_cross_through_convert():
    p = port_params(jmm.MultirotorMPPIParams())
    assert isinstance(p, mm.MultirotorMPPIParams)
    assert p.cost == mm.MultirotorCostParams() and p.model == mm.MultirotorMPPIParams().model
    np.testing.assert_array_equal(p.mppi.nominal_action, mm.hover_nominal(p.model.vehicle))
    np.testing.assert_array_equal(p.mppi.u_max, [300.0, 0.35, 0.35, 0.6])


@pytest.mark.parametrize("mode", ["attitude", "wrench"])
def test_solves_match_jax(mode):
    jp = jax_params(mode=mode)
    jstep, jinit = jmm.make_multirotor_solver(jp)
    step, init = mm.make_multirotor_solver(port_params(jp), device="cpu")
    jst, st = _state()
    target = np.asarray([1.0, -0.5, 2.5], np.float32)
    jobs = jmm.MultirotorObs(state=jst, target=jnp.asarray(target))
    obs = mm.MultirotorObs(state=st, target=T(target))
    js, s = jinit(jax.random.key(5)), init(0)
    close(s.u_prev, js.u_prev, 0, "warm start")
    key, jstep = js.key, jax.jit(jstep)
    for i in range(3):
        key, z = shared_z(key, 128, 16, 4)
        jout, js = jstep(js, jobs)
        out, s = step(s, obs, T(z))
        close(out.u_seq, jout.u_seq, TOL_SOLVE, f"solve {i}: u_seq")
        assert torch.equal(out.action, out.u_seq[0])
    close(s.u_prev, js.u_prev, TOL_SOLVE, "warm start")


def test_batched_solve_equals_unbatched():
    p = port_params(jax_params())
    step, init = mm.make_multirotor_solver(p, device="cpu", n_scenarios=2)
    step1, init1 = mm.make_multirotor_solver(p, device="cpu")
    states = [_state(i)[1] for i in (1, 2)]
    obs_b = mm.MultirotorObs(state=Multirotor12State(*(torch.stack(f) for f in zip(*states))),
                             target=torch.tensor([[1.0, 0.0, 2.0], [0.0, -1.0, 3.0]]))
    s, singles = init([3, 4]), [init1(3), init1(4)]
    for _ in range(2):
        out, s = step(s, obs_b)
        for b in range(2):
            one, singles[b] = step1(singles[b], mm.MultirotorObs(
                state=Multirotor12State(*(x[b] for x in obs_b.state)), target=obs_b.target[b]))
            close(out.u_seq[b], N(one.u_seq), TOL_BATCH)


def _jax_waypoint_loop(jp, target, n, seed):
    """The JAX scenario's perfect-model loop (``run_multirotor_waypoint``)."""
    jstep, jinit = jmm.make_multirotor_solver(jp)
    zq = jnp.zeros(1)
    tgt = jnp.asarray(target)

    def body(carry, _):
        st, sol = carry
        out, sol = jstep(sol, jmm.MultirotorObs(state=st, target=tgt))
        st = jbase12(jmm._base_rollout_attitude(
            jp.model, JWBState(base=st, q=zq, qdot=zq), out.action[None, None, :], 0.01, 1))
        return (st, sol), (st.pos, jnp.linalg.norm(st.pos - tgt))

    st0 = JState12(pos=jnp.asarray([0.0, 0.0, 2.0]), rpy=jnp.zeros(3), vel=jnp.zeros(3),
                   omega=jnp.zeros(3))
    sol0 = jinit(jax.random.key(seed))
    _, logs = jax.jit(lambda c: jax.lax.scan(body, c, None, length=n))((st0, sol0))
    return sol0.key, logs


def test_perfect_model_loop_matches_jax():
    """20 steps of the waypoint loop, each solve on the JAX step's draw."""
    n, k, h = 20, 128, 16
    jp = jax_params(k, h)
    key, (jpos, jerr) = _jax_waypoint_loop(jp, WAYPOINT, n, seed=2)
    zs = []
    for _ in range(n):
        key, z = shared_z(key, k, h, 4)
        zs.append(z)
    run, start = multirotor_episode(port_params(jp), WAYPOINT, n, "cpu")
    (state, sol), (err,) = run(start(0), z=T(np.stack(zs)))
    close(err, jerr, TOL_LOOP, "distance to the waypoint")
    close(state.pos, jpos[-1], TOL_LOOP, "final position")
    assert sol.step.tolist() == [n]


def _jax_whole_body_loop(jp, n, seed):
    """The JAX ``run_whole_body`` loop (the XLA step) at ``jp``."""
    jstep, jinit = jwb.make_whole_body_solver(jp, low_k_guard="off")
    obs0 = jwb.default_obs()
    spec = jp.model.chain()

    def body(carry, _):
        st, sol = carry
        out, sol = jstep(sol, jwb.WholeBodyObs(state=st, ee_target=obs0.ee_target,
                                               base_target=obs0.base_target))
        _, q, qdot, base = jwbm.rollout(jp.model, st, out.action[None, None, :], 0.01)
        st = JWBState(base=jbase12(base), q=q[0, 0], qdot=qdot[0, 0])
        ee, _ = jchain.forward_kinematics_posquat(spec, st.q, base_pos=st.base.pos,
                                                  base_quat=jwbm._quat_from_rpy(st.base.rpy))
        return (st, sol), (jnp.linalg.norm(ee - obs0.ee_target.position), st.base.pos)

    sol0 = jinit(jax.random.key(seed))
    _, logs = jax.jit(lambda c: jax.lax.scan(body, c, None, length=n))((obs0.state, sol0))
    return sol0.key, logs


@pytest.mark.filterwarnings("ignore:attitude-mode whole-body MPPI")
def test_whole_body_loop_matches_jax():
    """10 steps of the perfect-model whole-body loop at K=64, H=10, each
    solve on the JAX step's draw."""
    n, k, h = 10, 64, 10
    jp = small(jwb.WholeBodyMPPIParams(), k, h)
    key, (jerr, jbase) = _jax_whole_body_loop(jp, n, seed=1)
    zs = []
    for _ in range(n):
        key, z = shared_z(key, k, h)
        zs.append(z)
    run, start = whole_body_episode(convert.params_from_dict(jcfg.to_dict(jp)), n, "cpu")
    _, (err, base) = run(start(0), z=T(np.stack(zs)))
    close(err, jerr, TOL_WHOLE_BODY, "EE error")
    close(base, jbase, TOL_WHOLE_BODY, "base position")


@pytest.mark.filterwarnings("ignore:attitude-mode whole-body MPPI")
def test_run_whole_body_on_the_cpu():
    r = run_whole_body(seed=0, steps=4, device="cpu", n_samples=64)
    assert set(r) == {"initial_ee_err_m", "min_ee_err_m", "final_ee_err_m", "base_alt_final_m"}
    assert abs(r["base_alt_final_m"] - 2.1) < 0.1 and r["min_ee_err_m"] <= r["initial_ee_err_m"]


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """The multirotor, fixed-wing and mapped builders and scenarios run on
    the card unless asked for the CPU, and raise where there is none."""
    from quadrotor_manipulator_mppi_tpu_torch.models import fixed_wing as fw
    from quadrotor_manipulator_mppi_tpu_torch.scenarios import solvers
    from quadrotor_manipulator_mppi_tpu_torch.sim import occupancy as occ
    from quadrotor_manipulator_mppi_tpu_torch.solver import fixed_wing as fws
    from quadrotor_manipulator_mppi_tpu_torch.solver import mapped as ms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: mm.make_multirotor_solver(), lambda: fws.make_fixed_wing_solver(),
                  lambda: ms.make_mapped_solver(), lambda: fw.init_state(),
                  lambda: occ.init_grid(occ.OccupancyParams()),
                  lambda: solvers.run_mapped_flight(steps=1),
                  lambda: solvers.run_fixed_wing(steps=1),
                  lambda: solvers.run_multirotor_waypoint(steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_run_multirotor_waypoint_on_the_cpu():
    r = run_multirotor_waypoint(seed=0, steps=5, device="cpu", n_samples=64)
    assert set(r) == {"min_err_m", "final_err_m"}
    assert r["min_err_m"] <= r["final_err_m"] + 1e-4 < 2.7


# ---------------------------------------------------------------------------
# The JAX package's preset tests (tests/test_multirotor_mppi.py) on the port
# ---------------------------------------------------------------------------

def _port_loop(target, n_steps, seed=0):
    run, start = multirotor_episode(small(mm.MultirotorMPPIParams(), 256, 30), target, n_steps,
                                    "cpu")
    with torch.inference_mode():
        _, (err,) = run(start(seed))
    return N(err)


def test_hover_station_keeping():
    errs = _port_loop((0.0, 0.0, 2.0), 300)
    assert np.all(np.isfinite(errs))
    assert errs.max() < 0.5, f"drifted: max {errs.max():.3f}"


def test_waypoint_reach():
    errs = _port_loop(WAYPOINT, 500)
    assert errs.min() < 0.4, f"never reached: min {errs.min():.3f}"
    assert errs[-1] < 1.0, f"diverged: final {errs[-1]:.3f}"
