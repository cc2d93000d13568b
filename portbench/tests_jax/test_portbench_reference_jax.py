"""The plain reference against the JAX package, an implementation written
apart from the port, on the CPU at small sizes.

The reference (``portbench/reference/``) is a frozen copy of the port's
plain pipeline and eager loop, so holding it against the port alone would
compare the port with itself.  Here each entry point the check drives is
held against the JAX package's XLA build on the JAX key chain's normals
(passed to both as ``z``): chained packed solves, one solve from the
solver's observation fields, and episodes in two calls, the second from
the carry the first returned (the fleet check's restart).  Tests may import
JAX; no run of the benchmark does, and a run refuses to report where JAX is
loaded in its process, so these tests live apart from ``portbench/tests``
(whose runs are in-process) and run in a pytest process of their own:

    JAX_PLATFORMS=cpu python3 -m pytest portbench/tests_jax -q
  The solves' tolerance is the port's
own parity test's (``tests/test_torch_serving.py``: the softmin amplifies
float32 rounding to some 5e-4 over three chained solves); the episodes'
is five times tighter than the port's (``tests/test_torch_episode.py``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402

from portbench.reference import solve as ref  # noqa: E402
from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl  # noqa: E402
from quadrotor_manipulator_mppi_tpu.solver import serving as jserving  # noqa: E402
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb  # noqa: E402

CONFIGS = {n: json.loads((ROOT / f"portbench/configs/{n}.json").read_text())
           for n in ("wb_att_k4096", "wb_pos_k512")}
# The wrench preset by name (no cell runs it yet): what a wrench configuration file states.
CONFIGS["wb_wrench_k4096"] = dict(CONFIGS["wb_att_k4096"], name="wb_wrench_k4096",
                                  preset="wrench", control_mode="wrench",
                                  sigma=[8.0, 1.2, 1.2, 0.5] + [1.0] * 7)
SOLVE_TOL = 2e-3  # rtol and atol, as the port's test_packed_matches_jax_packed
EPISODE_TOL = 1e-3  # atol; the port's test_episode_matches_jax takes 5e-3


def jax_params(name: str, k: int, h: int):
    import dataclasses

    preset = CONFIGS[name]["preset"]
    if preset == "attitude":
        p = jwb.WholeBodyMPPIParams()
        return dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, n_samples=k, n_horizon=h))
    return getattr(jwb, f"{preset}_mode_params")(n_samples=k, n_horizon=h)


def z_chain(key, n: int, k: int, h: int, a: int = 11):
    """The JAX solver's draws for ``n`` steps from ``key``: (next key, z)."""
    zs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(sub, (k, h, a))))
    return key, np.stack(zs)


def perturbed_obs():
    obs = jwb.default_obs()
    base = obs.state.base._replace(
        pos=jnp.asarray([0.3, -0.2, 2.4]), rpy=jnp.asarray([0.05, -0.08, 0.4]),
        vel=jnp.asarray([0.1, 0.2, -0.05]), omega=jnp.asarray([0.01, -0.02, 0.03]))
    return obs._replace(state=obs.state._replace(base=base, qdot=jnp.full(7, 0.1)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_packed_solves_follow_jax(name):
    k, h = 256, 12
    jp = jax_params(name, k, h)
    jstep, jinit = jserving.make_packed_step(jp, backend="xla", low_k_guard="off")
    jcarry = jinit(jax.random.key(5))
    r = ref.Reference(CONFIGS[name], "cpu", torch.float64, n_samples=k, n_horizon=h)
    u = r.initial_warm_start()
    np.testing.assert_allclose(u.numpy(), np.asarray(jcarry.u_prev), atol=1e-6)
    obs_vec, target_vec = jserving.pack_obs(perturbed_obs())
    packed = np.concatenate([np.asarray(obs_vec), np.asarray(target_vec)])
    key = jcarry.key
    for i in range(3):
        key, z = z_chain(key, 1, k, h)
        jout, jcarry = jstep(jcarry, obs_vec, target_vec)
        out, u = r.solve_packed(u, 0, i, packed, z=z[0])
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=SOLVE_TOL, atol=SOLVE_TOL)
        np.testing.assert_allclose(u.numpy(), np.asarray(jcarry.u_prev), rtol=SOLVE_TOL,
                                   atol=SOLVE_TOL)


def test_solve_from_fields_follows_jax():
    k, h = 256, 12
    jp = jax_params("wb_att_k4096", k, h)
    jstep, jinit = jwb.make_whole_body_solver(jp, backend="xla", low_k_guard="off")
    js = jinit(jax.random.key(9))
    obs = perturbed_obs()
    _, z = z_chain(js.key, 1, k, h)
    jout, jnew = jax.jit(jstep)(js, obs)
    b = obs.state.base
    fields = {"pos": b.pos, "rpy": b.rpy, "vel": b.vel, "omega": b.omega, "q": obs.state.q,
              "qdot": obs.state.qdot, "ee_pos": obs.ee_target.position,
              "ee_quat": obs.ee_target.quat, "base_target": obs.base_target}
    r = ref.Reference(CONFIGS["wb_att_k4096"], "cpu", torch.float64, n_samples=k, n_horizon=h)
    out, u = r.solve_fields(r.initial_warm_start(), 0, 0,
                            {f: np.asarray(v, dtype=np.float64) for f, v in fields.items()},
                            z=z[0])
    want = np.concatenate([np.asarray(jout.action), np.asarray(jout.qdes),
                           np.asarray(jout.vdes)])
    np.testing.assert_allclose(out.numpy(), want, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(jnew.u_prev), rtol=SOLVE_TOL, atol=SOLVE_TOL)


def rows(final) -> dict:
    """A JAX episode's final carry as the reference's state rows (one vehicle)."""
    plant = final[0]

    def host(x):
        return np.asarray(x, dtype=np.float64)[None]

    return {"base": {f: host(getattr(plant.base, f)) for f in plant.base._fields},
            "q": host(plant.q), "qdot": host(plant.qdot),
            "ctrl": {f: host(getattr(plant.ctrl, f)) for f in plant.ctrl._fields},
            "u_prev": host(final[1].u_prev)}


@pytest.mark.parametrize("name,loop,k,h,n", [
    ("wb_pos_k512", {"arm_coeffs_per_control": True}, 64, 8, 10),
    ("wb_att_k4096", {}, 256, 12, 3),
    ("wb_wrench_k4096", {}, 256, 12, 3),
])
def test_episode_calls_follow_jax(name, loop, k, h, n):
    """Two calls of ``n`` control steps, the second from the first's final
    carry, in the JAX package and in the reference (float64) restarted from
    the JAX carry at solve index ``n``."""
    jp = jax_params(name, k, h)
    jrun = jax.jit(jwbl.make_whole_body_episode(jp, cfg=jwbl.WholeBodyLoopConfig(**loop),
                                                n_control_steps=n, low_k_guard="off"))
    _, jinit = jwb.make_whole_body_solver(jp, low_k_guard="off")
    obs = jwb.default_obs()
    js = jinit(jax.random.key(0))
    key, z1 = z_chain(js.key, n, k, h)
    _, z2 = z_chain(key, n, k, h)
    jfinal, jlogs = jrun(jwbl.init_plant(jp.model.vehicle), js, obs.ee_target, obs.base_target)
    jfinal2, jlogs2 = jrun(*jfinal)

    start = {"pos": np.asarray([[0.0, 0.0, 2.1]]),
             "ee_pos": np.asarray(obs.ee_target.position, dtype=np.float64)[None],
             "ee_quat": np.asarray(obs.ee_target.quat, dtype=np.float64)[None],
             "base_target": np.asarray(obs.base_target, dtype=np.float64)[None], "keys": [0]}
    r = ref.Reference(CONFIGS[name], "cpu", torch.float64, n_samples=k, n_horizon=h)
    got1, got_rows = r.episode(start, loop, n, z=z1[:, None])
    got2, _ = r.episode(start, loop, n, rows(jfinal), step0=n, z=z2[:, None])
    for got, want in ((got1, jlogs), (got2, jlogs2)):
        for f in ref.LOG_FIELDS:
            tol = 2 * EPISODE_TOL if f == "ori_err" else EPISODE_TOL
            np.testing.assert_allclose(got[f][0], np.asarray(getattr(want, f)), atol=tol,
                                       err_msg=f)
    np.testing.assert_allclose(got_rows["base"]["pos"][0], np.asarray(jfinal[0].base.pos),
                               atol=EPISODE_TOL)
