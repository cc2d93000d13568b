"""The port's sample-sharded solve, collectives and multi-process bring-up
on the CPU, held against the JAX package's sharded solve.

Two OS processes (``tests/torch_multiproc_worker.py``) join a ``gloo``
group through ``parallel.multihost.initialize`` and run the port once for
every case below; this process computes the JAX side on a 2-device sample
mesh of the virtual CPU devices and hands the workers each shard's noise,
rebuilt from ``fold_in(sub, shard)`` as ``tests/test_parallel.py`` does.
The drone preset runs sample-sharded too, on each rank's half of the JAX
unsharded preset's draws, and with a scenario axis (``batch_scenarios=True``,
1 and 2 scenarios) against the JAX sharded solve, vmapped, on each shard's
normals.  So do the multirotor, fixed-wing and mapped presets (spheres and
ESDF, two different maps in a batch), unbatched and with 2 scenarios,
against the JAX sharded solve on each shard's normals.  The workers import
no JAX.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.models import fixed_wing as jfw
from quadrotor_manipulator_mppi_tpu.models.multirotor import Multirotor12State as JState12
from quadrotor_manipulator_mppi_tpu.parallel import mesh as jmesh
from quadrotor_manipulator_mppi_tpu.parallel.sharded import make_sharded_solver as jsharded
from quadrotor_manipulator_mppi_tpu.sim import mapped_loop as jml
from quadrotor_manipulator_mppi_tpu.sim import occupancy as jocc
from quadrotor_manipulator_mppi_tpu.solver import drone as jdrone
from quadrotor_manipulator_mppi_tpu.solver import fixed_wing as jfws
from quadrotor_manipulator_mppi_tpu.solver import mapped as jms
from quadrotor_manipulator_mppi_tpu.solver import multirotor_mppi as jmm
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu_torch.ops import weights as tweights
from quadrotor_manipulator_mppi_tpu_torch.parallel import mesh as tmesh
from quadrotor_manipulator_mppi_tpu_torch.parallel import multihost, sharded
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

from torch_parity import shared_z, small, torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, H, A, N_SHARDS, N_STEPS = 2 * 128, 12, 11, 2, 2
DRONE_K = 64
DRONE_SCENARIOS = (1, 2)
TOLS = (2e-3, 4e-3)  # first and second solve, as tests/test_parallel.py
FLIGHT_K, FLIGHT_H = 64, 8
FLIGHT_PRESETS = ("multirotor", "fixed_wing", "mapped_spheres", "mapped_esdf")
FLIGHT_SCENARIOS = (0, 2)  # 0: batch_scenarios=False; 2: two scenarios
TOL_FLIGHT = 2e-4  # of the largest entry: tests/test_torch_multirotor.py's TOL_SOLVE


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_sharded(jp, **kwargs):
    """(outputs per step, z blocks per step and shard) of the JAX sharded
    solve on a 2-shard sample mesh."""
    mesh = jmesh.make_mesh(n_sample_shards=N_SHARDS, devices=jax.devices()[:N_SHARDS])
    step, init = jsharded(jwb.make_whole_body_solver, mesh, params=jp, **kwargs)
    states = jax.tree.map(lambda x: x[None], init(jax.random.key(3)))
    obs = jax.tree.map(lambda x: x[None], jwb.default_obs())
    key, outs, zs = states.key[0], [], []
    with jax.set_mesh(mesh):
        jstep = jax.jit(step)
        for _ in range(N_STEPS):
            key, sub = jax.random.split(key)
            zs.append([np.asarray(jax.random.normal(jax.random.fold_in(sub, i),
                                                    (K // N_SHARDS, H, A)))
                       for i in range(N_SHARDS)])
            out, states = jstep(states, obs)
            outs.append((np.asarray(out.u_seq[0]), np.asarray(states.u_prev[0]),
                         np.asarray(states.sigma[0])))
    return outs, zs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Run both ranks once; returns (JAX references, rank 0's results,
    rank 1's results, the collectives' inputs)."""
    jp = small(jwb.position_mode_params(), k=K, h=H)
    ref_xla, zs = _jax_sharded(jp)
    ref_pallas, zs_p = _jax_sharded(jp, backend="pallas", pallas_use_prng=False,
                                    pallas_interpret=True)
    for a, b in zip(zs, zs_p):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    rng = np.random.default_rng(0)
    coll = {"s_global": rng.uniform(0, 50, size=256).astype(np.float32),
            "noise_global": rng.normal(size=(256, 16, 3)).astype(np.float32)}
    d = tmp_path_factory.mktemp("torch_mp")
    inp = {"params_json": json.dumps(jcfg.to_dict(jp)), "n_steps": N_STEPS, **coll}
    for i, blocks in enumerate(zs):
        for r, z in enumerate(blocks):
            inp[f"z_rank{r}_step{i}"] = z
    ref_drone, drone_inp = _jax_drone()
    inp.update(drone_inp)
    ref_batched = {}
    for n_scn in DRONE_SCENARIOS:
        ref_batched[n_scn], batched_inp = _jax_drone_batched(n_scn)
        inp.update(batched_inp)
    ref_flight = {}
    for name in FLIGHT_PRESETS:
        for n_scn in FLIGHT_SCENARIOS:
            ref_flight[name, n_scn], flight_inp = _jax_flight(name, n_scn)
            inp.update(flight_inp)
    np.savez(d / "in.npz", **inp)

    worker = os.path.join(REPO, "tests", "torch_multiproc_worker.py")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, worker, init_method, str(r), str(N_SHARDS),
                               str(d / "in.npz"), str(d)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(N_SHARDS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [dict(np.load(d / f"rank{r}.npz")) for r in range(N_SHARDS)]
    return ({"xla": ref_xla, "pallas": ref_pallas, "drone": ref_drone,
             "drone_batched": ref_batched, "flight": ref_flight}, res[0], res[1], coll)


def _jax_drone():
    """(outputs per step, worker inputs) of the JAX drone preset at
    K=DRONE_K unsharded: each rank gets its half of every step's draws."""
    jp = jdrone.DroneMPPIParams()
    jp = dataclasses.replace(jp, mppi=dataclasses.replace(jp.mppi, n_samples=DRONE_K))
    step, init = jdrone.make_drone_solver(jp)
    step = jax.jit(step)
    x, v, target = (np.asarray(a, np.float32) for a in
                    ((0.1, -0.2, 1.0), (0.0, 0.3, 0.0), jdrone.DEFAULT_TARGET))
    obs = jdrone.DroneObs(x=jnp.asarray(x), v=jnp.asarray(v), target=jnp.asarray(target))
    state = init(jax.random.key(8))
    key, outs = state.key, []
    inp = {"drone_params_json": json.dumps(jcfg.to_dict(jp)), "drone_x": x, "drone_v": v,
           "drone_target": target}
    half = DRONE_K // N_SHARDS
    for i in range(N_STEPS):
        key, z = shared_z(key, DRONE_K, 32, a=3)
        for r in range(N_SHARDS):
            inp[f"drone_z_rank{r}_step{i}"] = z[r * half:(r + 1) * half]
        out, state = step(state, obs)
        outs.append((np.asarray(out.u_seq), np.asarray(out.xdes)))
    return outs, inp


def _jax_drone_batched(n_scn):
    """(outputs per step, worker inputs) of the JAX sharded drone solve with
    ``batch_scenarios=True`` (``tests/test_parallel.py``) on a 2-shard
    sample mesh: ``n_scn`` scenarios, vmapped, each shard's normals
    rebuilt from ``fold_in(sub, shard)`` of its scenario's key."""
    from quadrotor_manipulator_mppi_tpu.parallel.sharded import scenario_keys

    jp = jdrone.DroneMPPIParams()
    jp = dataclasses.replace(jp, mppi=dataclasses.replace(jp.mppi, n_samples=DRONE_K))
    mesh = jmesh.make_mesh(n_sample_shards=N_SHARDS, devices=jax.devices()[:N_SHARDS])
    step, init = jsharded(jdrone.make_drone_solver, mesh, batch_scenarios=True, params=jp)
    states = jax.vmap(init)(scenario_keys(jax.random.key(9), n_scn))
    rng = np.random.default_rng(n_scn)
    x = (np.asarray([0.2, -0.1, 1.0]) + rng.normal(scale=0.3, size=(n_scn, 3))).astype(np.float32)
    v = rng.normal(scale=0.2, size=(n_scn, 3)).astype(np.float32)
    target = np.tile(np.asarray(jdrone.DEFAULT_TARGET, np.float32), (n_scn, 1))
    obs = jdrone.DroneObs(x=jnp.asarray(x), v=jnp.asarray(v), target=jnp.asarray(target))
    tag = f"dbatch{n_scn}"
    inp = {f"{tag}_x": x, f"{tag}_v": v, f"{tag}_target": target}
    half, outs = DRONE_K // N_SHARDS, []
    with jax.set_mesh(mesh):
        jstep = jax.jit(step)
        for i in range(N_STEPS):
            subs = [jax.random.split(states.key[b])[1] for b in range(n_scn)]
            for r in range(N_SHARDS):
                inp[f"{tag}_z_rank{r}_step{i}"] = np.stack([
                    np.asarray(jax.random.normal(jax.random.fold_in(sub, r), (half, 32, 3)))
                    for sub in subs])
            out, states = jstep(states, obs)
            outs.append((np.asarray(out.u_seq), np.asarray(out.xdes)))
    return outs, inp


def _flight_jax_params(name):
    """(JAX preset factory, JAX params) at K=FLIGHT_K, H=FLIGHT_H."""
    if name == "multirotor":
        make, jp = jmm.make_multirotor_solver, jmm.MultirotorMPPIParams()
    elif name == "fixed_wing":
        make, jp = jfws.make_fixed_wing_solver, jfws.FwMPPIParams()
    else:
        make = jms.make_mapped_solver
        jp = jms.MappedMPPIParams(altitude_weight=8.0, use_esdf=name == "mapped_esdf",
                                  esdf_params=jml.MappedFlightConfig().grid)
    return make, small(jp, FLIGHT_K, FLIGHT_H)


def _flight_obs_arrays(name, n_scn):
    """The observation's fields as float32 numpy, from a numpy seed: one
    problem (n_scn 0) or n_scn, each scenario its own (the mapped
    scenarios on two different maps)."""
    rng = np.random.default_rng(len(name) + 10 * n_scn)
    lead = (n_scn,) if n_scn else ()

    def f32(x):
        return np.asarray(x, np.float32)

    if name == "multirotor":
        return {"pos": f32(rng.normal(size=lead + (3,)) + [0.0, 0.0, 2.0]),
                "rpy": f32(rng.normal(scale=0.1, size=lead + (3,))),
                "vel": f32(rng.normal(scale=0.5, size=lead + (3,))),
                "omega": f32(rng.normal(scale=0.2, size=lead + (3,))),
                "target": f32(rng.normal(size=lead + (3,)) + [1.0, 2.0, 3.4])}
    if name == "fixed_wing":
        aa = rng.normal(scale=0.1, size=lead + (3,))
        return {"pos": f32(rng.normal(scale=5.0, size=lead + (3,)) + [10.0, -5.0, 95.0]),
                "quat": f32(jrot.quat_from_axis_angle(jnp.asarray(aa))),
                "vel": f32(rng.normal(size=lead + (3,)) + [14.0, 1.0, -0.5]),
                "omega": f32(rng.normal(scale=0.05, size=lead + (3,))),
                "target": f32(rng.normal(scale=20.0, size=lead + (3,)) + [250.0, 60.0, 110.0]),
                "cruise": f32(15.0 + rng.uniform(size=lead))}
    op = jml.MappedFlightConfig().grid
    maps = []
    for b in range(max(n_scn, 1)):
        lo = np.where(rng.uniform(size=op.shape) < 0.5, jocc.LOG_ODDS_MISS, 0.0)
        lo[17 - 6 * b:21 - 6 * b, 14:19, 3:6] = jocc.LOG_ODDS_MAX  # a block near the line
        grid = jocc.OccupancyGrid(jnp.asarray(lo, jnp.float32))
        c, r = jocc.occupied_centers(op, grid)
        maps.append((np.asarray(c), np.asarray(jnp.where(r > 0, r + 0.65, 0.0)),
                     np.asarray(jocc.distance_field(op, grid))))
    out = {"x": f32(rng.normal(scale=0.2, size=lead + (3,)) + [0.5, 0.1, 1.8]),
           "v": f32(rng.normal(scale=0.3, size=lead + (3,)) + [1.5, 0.2, 0.0]),
           "target": f32(np.broadcast_to([9.0, 0.0, 1.8], lead + (3,)))}
    for i, key in enumerate(("centers", "radii", "dist")):
        out[key] = f32(np.stack([m[i] for m in maps]) if n_scn else maps[0][i])
    return out


def _flight_jax_obs(name, arr):
    a = {k: jnp.asarray(v) for k, v in arr.items()}
    if name == "multirotor":
        return jmm.MultirotorObs(JState12(a["pos"], a["rpy"], a["vel"], a["omega"]), a["target"])
    if name == "fixed_wing":
        return jfws.FwObs(jfw.FixedWingState(a["pos"], a["quat"], a["vel"], a["omega"]),
                          a["target"], a["cruise"])
    return jms.MappedObs(a["x"], a["v"], a["target"], a["centers"], a["radii"],
                         a["dist"] if name == "mapped_esdf" else None)


def _jax_flight(name, n_scn):
    """(outputs per step, worker inputs) of the JAX sharded preset on a
    2-shard sample mesh, ``batch_scenarios=False`` (n_scn 0) or True with
    n_scn scenarios, vmapped; each shard's normals rebuilt from
    ``fold_in(sub, shard)`` of its scenario's key."""
    from quadrotor_manipulator_mppi_tpu.parallel.sharded import scenario_keys

    make, jp = _flight_jax_params(name)
    mesh = jmesh.make_mesh(n_sample_shards=N_SHARDS, devices=jax.devices()[:N_SHARDS])
    step, init = jsharded(make, mesh, batch_scenarios=bool(n_scn), params=jp)
    states = (jax.vmap(init)(scenario_keys(jax.random.key(9), n_scn)) if n_scn
              else init(jax.random.key(9)))
    arr = _flight_obs_arrays(name, n_scn)
    obs = _flight_jax_obs(name, arr)
    tag = f"{name}_b{n_scn}"
    port_jp = jp
    if name.startswith("mapped"):  # the JAX schedule is a bare lambda: the worker restores it
        port_jp = dataclasses.replace(jp, mppi=dataclasses.replace(jp.mppi, sigma_scale_fn=None))
    inp = {f"{tag}_params_json": json.dumps(jcfg.to_dict(port_jp)),
           **{f"{tag}_obs_{k}": v for k, v in arr.items()}}
    half, a, outs = FLIGHT_K // N_SHARDS, jp.mppi.n_action, []
    with jax.set_mesh(mesh):
        jstep = jax.jit(step)
        for i in range(N_STEPS):
            keys = [states.key[b] for b in range(n_scn)] if n_scn else [states.key]
            subs = [jax.random.split(k)[1] for k in keys]
            for r in range(N_SHARDS):
                zs = [np.asarray(jax.random.normal(jax.random.fold_in(sub, r), (half, FLIGHT_H, a)))
                      for sub in subs]
                inp[f"{tag}_z_rank{r}_step{i}"] = np.stack(zs) if n_scn else zs[0]
            out, states = jstep(states, obs)
            outs.append((np.asarray(out.u_seq), np.asarray(states.u_prev)))
    return outs, inp


def test_initialize_joins_the_group_once(run):
    _, r0, r1, _ = run
    np.testing.assert_array_equal(r0["topo"], [0, 2, 1, 0])
    np.testing.assert_array_equal(r1["topo"], [1, 2, 1, 1])


@pytest.mark.parametrize("rank", [0, 1])
def test_make_mesh_rank_layout(run, rank):
    res = run[1 + rank]
    # all ranks on the sample axis: scenario row 0, sample column = rank,
    # group rank = sample index; one rank per row: no group at all
    np.testing.assert_array_equal(res["mesh"], [rank, 0, rank, 2, 1, rank, rank, 0, 1])


def test_group_collectives_equal_the_unsharded_reductions(run):
    _, r0, r1, coll = run
    s, noise = torch.tensor(coll["s_global"]), torch.tensor(coll["noise_global"])
    w = tweights.softmin_weights(s, 0.1)
    want = tweights.weighted_noise_average(w, noise).numpy()
    for res in (r0, r1):
        np.testing.assert_allclose(res["collective_du"], want, rtol=1e-5, atol=1e-6)
    # each rank's weights are its share of one global normalisation
    np.testing.assert_allclose(r0["collective_wsum"] + r1["collective_wsum"], 1.0, rtol=1e-5)


@pytest.mark.parametrize("field", ["u_seq", "u_prev", "sigma"])
@pytest.mark.parametrize("port, ref", [("torch", "xla"), ("cuda", "pallas")])
def test_sharded_solve_matches_jax(run, port, ref, field):
    """The port's plain pipeline against the JAX XLA sharded step, and its
    kernel step (plain versions of rows 2 and 7 here) against the JAX
    Pallas sharded step, on the JAX shards' noise, over two solves."""
    refs, r0, r1, _ = run
    col = ("u_seq", "u_prev", "sigma").index(field)
    for i, tol in enumerate(TOLS):
        want = refs[ref][i][col]
        for res in (r0, r1):
            np.testing.assert_allclose(res[f"{port}_{field}_{i}"], want, rtol=tol, atol=tol)


@pytest.mark.parametrize("spill", [1, 0])
def test_sharded_philox_solve_equals_the_one_rank_solve(run, spill):
    """Rows 1+7 (spill) and 4+6 (no spill) on two ranks draw the one-rank
    noise set at global sample offsets: three solves equal the one-rank K
    solve on the same seed up to summation order."""
    for res in run[1:3]:
        assert float(res[f"philox_err_spill{spill}"]) <= 1e-5


def test_three_collectives_per_solve_four_with_adaptive_sigma(run):
    # (kernel step, plain pipeline) x (schedule, adaptive sigma)
    for res in run[1:3]:
        np.testing.assert_array_equal(res["collective_counts"], [3, 3, 4, 4])


@pytest.mark.parametrize("layout", ["rows", "samples"])
def test_sharded_scenario_batch_equals_one_rank_batch(run, layout):
    """Two scenarios split over two scenario rows (one each), or solved by
    two sample ranks (both), against one rank solving the batch."""
    for res in run[1:3]:
        assert int(res[f"batch_n_{layout}"]) == (1 if layout == "rows" else 2)
        assert float(res[f"batch_err_{layout}"]) <= 1e-5


def test_sharded_drone_philox_solve_equals_the_one_rank_solve(run):
    """make_drone_solver through make_sharded_solver (batch_scenarios=False),
    K=64 as 2 x 32: three solves equal the one-rank solve on the same seed,
    relative to the plan's largest entry (summation order only)."""
    for res in run[1:3]:
        assert float(res["drone_philox_err"]) <= 1e-6


@pytest.mark.parametrize("field", ["u_seq", "xdes"])
def test_sharded_drone_solve_matches_jax(run, field):
    """The same sharded solve on each rank's half of the JAX draws against
    the JAX unsharded drone preset, at the Pallas-vs-XLA tolerance."""
    refs, r0, r1, _ = run
    col = ("u_seq", "xdes").index(field)
    for i, ref in enumerate(refs["drone"]):
        for res in (r0, r1):
            np.testing.assert_allclose(res[f"drone_{field}_{i}"], ref[col], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_scn", DRONE_SCENARIOS)
@pytest.mark.parametrize("field", ["u_seq", "xdes"])
def test_sharded_batched_drone_solve_matches_jax(run, n_scn, field):
    """make_drone_solver through make_sharded_solver with
    batch_scenarios=True (1 and 2 scenarios, K=64 as 2 x 32) on each
    rank's blocks of the JAX sharded solve's normals, against that solve
    (tests/test_parallel.py) at the drone step tolerance, over two solves."""
    refs, r0, r1, _ = run
    col = ("u_seq", "xdes").index(field)
    for i, ref in enumerate(refs["drone_batched"][n_scn]):
        for res in (r0, r1):
            got = res[f"dbatch{n_scn}_{field}_{i}"]
            assert got.shape == ref[col].shape
            np.testing.assert_allclose(got, ref[col], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_scn", DRONE_SCENARIOS)
def test_sharded_batched_drone_solve_keeps_three_collectives(run, n_scn):
    """A batched sharded drone solve makes 3 all-reduces (4 with adaptive
    sigma), whatever the number of scenarios, and its Philox solve equals
    the one-rank batched solve on the same seed (summation order only)."""
    for res in run[1:3]:
        np.testing.assert_array_equal(res[f"dbatch{n_scn}_collectives"], [3, 4])
        assert float(res[f"dbatch{n_scn}_philox_err"]) <= 1e-6


def test_sharded_arm_solve_equals_the_one_rank_solve(run):
    """make_arm_solver through make_sharded_solver (batch_scenarios=False),
    K=100 as 2 x 50: three solves (plan, qdes, warm start) equal the
    one-rank arm solve on the same seed up to summation order."""
    for res in run[1:3]:
        assert float(res["arm_philox_err"]) <= 1e-5


@pytest.mark.parametrize("n_scn", FLIGHT_SCENARIOS)
@pytest.mark.parametrize("name", FLIGHT_PRESETS)
def test_sharded_flight_preset_matches_jax(run, name, n_scn):
    """make_multirotor_solver, make_fixed_wing_solver and make_mapped_solver
    (spheres, ESDF) through make_sharded_solver, K=64 as 2 x 32, H=8, with
    batch_scenarios=False (n_scn 0) and with 2 scenarios, on each rank's
    blocks of the JAX sharded solve's normals, against that solve over two
    solves (plan and warm start, of the largest entry)."""
    refs, r0, r1, _ = run
    for i, want in enumerate(refs["flight"][name, n_scn]):
        for res in (r0, r1):
            for col, what in enumerate(("u_seq", "u_prev")):
                got = res[f"{name}_b{n_scn}_{what}_{i}"]
                assert got.shape == want[col].shape
                np.testing.assert_allclose(
                    got, want[col], rtol=0, atol=TOL_FLIGHT * max(1.0, np.abs(want[col]).max()),
                    err_msg=f"solve {i}: {what}")


@pytest.mark.parametrize("n_scn", FLIGHT_SCENARIOS)
@pytest.mark.parametrize("name", FLIGHT_PRESETS)
def test_sharded_flight_preset_philox_solve_equals_the_one_rank_solve(run, name, n_scn):
    """The same presets on the Philox stream: three sharded solves equal the
    one-rank solve on the same seed (summation order only, of the plan's
    largest entry), with 3 all-reduces per solve."""
    for res in run[1:3]:
        assert float(res[f"{name}_b{n_scn}_philox_err"]) <= 1e-6
        assert int(res[f"{name}_b{n_scn}_collectives"]) == 3


def test_weak_scaling_reports_the_jax_keys(run):
    want = {"devices", "backend", "k_per_device", "h", "t_1dev_ms", "t_sample_sharded_ms",
            "t_scenario_sharded_ms", "weak_eff_sample_axis", "weak_eff_scenario_axis",
            "global_k_sample_axis", "global_solves_per_s_scenario_axis"}
    res = run[1]
    assert set(res["scaling_keys"].tolist()) == want
    assert str(res["scaling_backend"]) == "cuda"  # the default backend's name
    devices, global_k, *times = res["scaling_vals"]
    assert (devices, global_k) == (2, 128)
    assert all(np.isfinite(t) and t > 0 for t in times)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_weak_scaling_takes_the_backend_on_one_rank(backend):
    """measure_weak_scaling(backend=...) on one gloo rank of this process:
    the JAX result's keys, the backend's name in "backend", finite times."""
    from quadrotor_manipulator_mppi_tpu_torch.parallel import scaling as tscaling

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        sc = tscaling.measure_weak_scaling(k_per_device=32, h=8, iters=1, device="cpu",
                                           backend=backend)
    finally:
        dist.destroy_process_group()
    assert set(sc) == {"devices", "backend", "k_per_device", "h", "t_1dev_ms",
                       "t_sample_sharded_ms", "t_scenario_sharded_ms", "weak_eff_sample_axis",
                       "weak_eff_scenario_axis", "global_k_sample_axis",
                       "global_solves_per_s_scenario_axis"}
    assert sc["backend"] == backend and sc["devices"] == 1 and sc["global_k_sample_axis"] == 32
    assert all(np.isfinite(sc[k]) and sc[k] > 0 for k in sc if k.startswith("t_"))


def test_bench_scaling_runs_the_plain_pipeline_on_the_cpu():
    """scenarios/scaling passes backend="torch" on the CPU, as the JAX runner
    passes "xla" there."""
    from quadrotor_manipulator_mppi_tpu_torch.scenarios import scaling as tscaling

    r = tscaling.run_bench_scaling(device="cpu", devices=1, k_per_device=32, iters=1)
    assert r["platform"] == "cpu" and r["backend"] == "torch" and r["devices"] == 1


def test_initialize_plumbs_args_and_environment(monkeypatch):
    """Explicit arguments and torchrun's environment reach
    ``init_process_group``; a single process initialises nothing; a second
    call never initialises again; the backend is never guessed."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)

    topo = multihost.initialize()
    assert calls == [] and topo == {"rank": 0, "world_size": 1, "backend": None,
                                    "initialized": False}

    multihost.initialize("tcp://localhost:1234", 4, 2, backend="gloo")
    assert calls[-1] == {"backend": "gloo", "init_method": "tcp://localhost:1234",
                         "world_size": 4, "rank": 2}

    monkeypatch.setenv("MASTER_ADDR", "h0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    multihost.initialize(backend="nccl")
    assert calls[-1] == {"backend": "nccl", "init_method": "env://", "world_size": 8,
                         "rank": 5}
    # explicit arguments win over the environment
    multihost.initialize("tcp://h1:1", 2, 1, backend="gloo")
    assert calls[-1] == {"backend": "gloo", "init_method": "tcp://h1:1", "world_size": 2,
                         "rank": 1}

    with pytest.raises(ValueError, match="name the backend"):
        multihost.initialize()

    n = len(calls)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 5)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    topo = multihost.initialize(backend="nccl")
    assert len(calls) == n and topo["initialized"] and topo["rank"] == 5


def test_make_mesh_needs_an_initialised_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        tmesh.make_mesh()


def test_host_local_scenarios_slices_the_scenario_axis():
    mesh = tmesh.Mesh(n_scenario_shards=4, n_sample_shards=2, rank=5, scenario_index=2,
                      sample_index=1)
    obs = twb.default_obs(device="cpu")
    batch = multihost.tree_map(lambda x: torch.stack([x + i for i in range(8)]), obs)
    local = multihost.host_local_scenarios(mesh, batch)
    torch.testing.assert_close(local.state.q, batch.state.q[4:6])
    torch.testing.assert_close(local.base_target, batch.base_target[4:6])
    assert multihost.host_local_scenarios(mesh, {"x": np.arange(8)})["x"].tolist() == [4, 5]
    with pytest.raises(ValueError, match="not divisible by 4 scenario shards"):
        multihost.host_local_scenarios(mesh, torch.zeros(6, 3))


def test_make_sharded_solver_checks():
    """The JAX function's checks and messages."""
    mesh = tmesh.Mesh(n_scenario_shards=1, n_sample_shards=2, rank=0, scenario_index=0,
                      sample_index=0)
    with pytest.raises(ValueError, match="requires explicit params="):
        sharded.make_sharded_solver(twb.make_whole_body_solver, mesh, device="cpu")
    three = dataclasses.replace(mesh, n_sample_shards=3)
    with pytest.raises(ValueError, match="n_samples 256 not divisible by 3 shards"):
        sharded.make_sharded_solver(twb.make_whole_body_solver, three, device="cpu",
                                    params=twb.position_mode_params(256, 8))
    rows = dataclasses.replace(mesh, n_scenario_shards=2, n_sample_shards=1)
    with pytest.raises(ValueError, match="3 scenarios not divisible by 2 scenario shards"):
        sharded.make_sharded_solver(twb.make_whole_body_solver, rows, n_scenarios=3,
                                    params=twb.position_mode_params(128, 8), device="cpu")


def test_scenario_seeds_are_distinct_and_reproducible():
    a = sharded.scenario_seeds(7, 256)
    assert a == sharded.scenario_seeds(7, 256) and len(set(a)) == 256
    assert a[:4] == sharded.scenario_seeds(7, 4)
    assert all(0 <= s < 2**63 for s in a)
    assert a != sharded.scenario_seeds(8, 256)
