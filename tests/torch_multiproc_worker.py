"""One rank of the port's two-process sharded-solve checks.

Each of two OS processes joins a ``gloo`` process group through
``parallel.multihost.initialize`` and runs the port's sample-sharded and
scenario-sharded whole-body solves, its sample-sharded drone solve,
unbatched and with a scenario axis, the sample-sharded arm solve, and the
multirotor, fixed-wing and mapped presets sample-sharded, unbatched and
with a scenario axis, on the CPU.  Everything that needs JAX was computed
by the parent test (``tests/test_torch_parallel.py``) and arrives as numpy
arrays in ``in.npz``; this process imports PyTorch and the port only.  Each
rank writes its results to ``<out_dir>/rank<r>.npz`` for the parent to hold
against the JAX package and against the one-rank solve.

    python tests/torch_multiproc_worker.py <init_method> <rank> <world> <in.npz> <out_dir>
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _counting_all_reduce(calls: list):
    """``dist.all_reduce`` that records each call's op in ``calls``."""
    inner = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(kwargs.get("op"))
        return inner(*args, **kwargs)

    return counted


def flight_case(name: str, tag: str, inp: dict):
    """(port preset factory, params, observation) of a flight preset case
    from the parent's arrays."""
    from quadrotor_manipulator_mppi_tpu_torch import convert
    from quadrotor_manipulator_mppi_tpu_torch.models import fixed_wing as fw
    from quadrotor_manipulator_mppi_tpu_torch.models.multirotor import Multirotor12State
    from quadrotor_manipulator_mppi_tpu_torch.solver import fixed_wing as fws
    from quadrotor_manipulator_mppi_tpu_torch.solver import mapped as ms
    from quadrotor_manipulator_mppi_tpu_torch.solver import multirotor_mppi as mm

    params = convert.config_from_dict(json.loads(str(inp[f"{tag}_params_json"])))
    a = {k[len(tag) + 5:]: torch.tensor(v) for k, v in inp.items()
         if k.startswith(f"{tag}_obs_")}
    if name == "multirotor":
        return (mm.make_multirotor_solver, params,
                mm.MultirotorObs(Multirotor12State(a["pos"], a["rpy"], a["vel"], a["omega"]),
                                 a["target"]))
    if name == "fixed_wing":
        return (fws.make_fixed_wing_solver, params,
                fws.FwObs(fw.FixedWingState(a["pos"], a["quat"], a["vel"], a["omega"]),
                          a["target"], a["cruise"]))
    params = dataclasses.replace(params, mppi=dataclasses.replace(
        params.mppi, sigma_scale_fn=ms.distance_to_go_scale))
    return (ms.make_mapped_solver, params,
            ms.MappedObs(a["x"], a["v"], a["target"], a["centers"], a["radii"],
                         a["dist"] if name == "mapped_esdf" else None))


def main():
    init_method, rank, world, in_path, out_dir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)

    from quadrotor_manipulator_mppi_tpu_torch import convert
    from quadrotor_manipulator_mppi_tpu_torch.ops import weights
    from quadrotor_manipulator_mppi_tpu_torch.parallel import mesh as mesh_mod
    from quadrotor_manipulator_mppi_tpu_torch.parallel import multihost, scaling, sharded
    from quadrotor_manipulator_mppi_tpu_torch.parallel.multihost import tree_map
    from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb

    topo = multihost.initialize(init_method, world, rank, backend="gloo")
    again = multihost.initialize(init_method, world, rank, backend="gloo")  # no second init
    inp = dict(np.load(in_path))
    params = convert.params_from_dict(json.loads(str(inp["params_json"])))
    out = {"topo": np.array([topo["rank"], topo["world_size"], int(topo["initialized"]),
                             again["rank"]])}

    # The mesh layouts of two ranks.
    m = mesh_mod.make_mesh()
    mc = mesh_mod.make_mesh(n_sample_shards=1, n_scenario_shards=2)
    out["mesh"] = np.array([m.rank, m.scenario_index, m.sample_index, m.n_sample_shards,
                            m.n_scenario_shards, dist.get_rank(m.sample_group),
                            mc.scenario_index, mc.sample_index, int(mc.sample_group is None)])

    # The collectives: this rank's half of a global sample set.
    k_half = inp["s_global"].shape[0] // 2
    sl = slice(rank * k_half, (rank + 1) * k_half)
    s_loc = torch.tensor(inp["s_global"][sl])
    noise_loc = torch.tensor(inp["noise_global"][sl])
    w = weights.softmin_weights(s_loc, 0.1, m.sample_group)
    out["collective_du"] = weights.weighted_noise_average(w, noise_loc, m.sample_group).numpy()
    out["collective_wsum"] = np.array(w.sum().item())

    # The sample-sharded solve on the JAX package's noise (this rank's
    # block of each solve), plain pipeline and kernel step.
    obs = wb.default_obs(device="cpu")
    n_steps = int(inp["n_steps"])
    for backend in ("torch", "cuda"):
        step, init = sharded.make_sharded_solver(
            wb.make_whole_body_solver, m, batch_scenarios=False, params=params,
            device="cpu", backend=backend)
        state = init(3)
        for i in range(n_steps):
            res, state = step(state, obs, inp[f"z_rank{rank}_step{i}"])
            out[f"{backend}_u_seq_{i}"] = res.u_seq.numpy()
            out[f"{backend}_u_prev_{i}"] = state.u_prev.numpy()
            out[f"{backend}_sigma_{i}"] = state.sigma.numpy()

    # The Philox stream: rows 1+7 and 4+6 against the one-rank solve on
    # the same seed, three consecutive solves.
    step1, init1 = wb.make_whole_body_solver(params, device="cpu")
    st1, ref = init1(11), []
    for _ in range(3):
        res, st1 = step1(st1, obs)
        ref.append(res.u_seq)
    for spill in (True, False):
        step, init = sharded.make_sharded_solver(
            wb.make_whole_body_solver, m, batch_scenarios=False, params=params,
            device="cpu", noise_spill=spill)
        st, err = init(11), 0.0
        for i in range(3):
            res, st = step(st, obs)
            err = max(err, (res.u_seq - ref[i]).abs().max().item())
        out[f"philox_err_spill{int(spill)}"] = np.array(err)

    # Collectives per solve: 3, and 4 with adaptive sigma.
    adaptive = dataclasses.replace(params, mppi=dataclasses.replace(
        params.mppi, adaptive_sigma=True, sigma_scale_fn=None))
    counts = []
    for p in (params, adaptive):
        for backend in ("cuda", "torch"):
            step, init = sharded.make_sharded_solver(
                wb.make_whole_body_solver, m, batch_scenarios=False, params=p,
                device="cpu", backend=backend)
            st, calls, plain = init(0), [], dist.all_reduce
            dist.all_reduce = _counting_all_reduce(calls)
            try:
                step(st, obs)
            finally:
                dist.all_reduce = plain
            counts.append(len(calls))
    out["collective_counts"] = np.array(counts)

    # Scenario batches: two global scenarios over the two scenario rows,
    # and over the two sample ranks, against one rank solving both.
    obs2 = tree_map(lambda x: torch.stack([x, x + 0.02]), obs)
    step_b, init_b = wb.make_whole_body_solver(params, device="cpu", n_scenarios=2)
    st_b = init_b(5)
    res_b, _ = step_b(st_b, obs2)
    for name, mesh in (("rows", mc), ("samples", m)):
        step, init = sharded.make_sharded_solver(
            wb.make_whole_body_solver, mesh, params=params, n_scenarios=2, device="cpu")
        local_obs = multihost.host_local_scenarios(mesh, obs2)
        res, _ = step(init(5), local_obs)
        want = multihost.host_local_scenarios(mesh, res_b.u_seq)
        out[f"batch_err_{name}"] = np.array((res.u_seq - want).abs().max().item())
        out[f"batch_n_{name}"] = np.array(res.u_seq.shape[0])

    # The drone preset, sample-sharded: its Philox solve against the
    # one-rank solve on the same seed over three solves, and its solve on
    # this rank's block of the JAX draws (held against JAX by the parent).
    from quadrotor_manipulator_mppi_tpu_torch.solver import drone

    dparams = convert.drone_params_from_dict(json.loads(str(inp["drone_params_json"])))
    dobs = drone.DroneObs(*(torch.tensor(inp[f"drone_{n}"]) for n in ("x", "v", "target")))
    dstep, dinit = sharded.make_sharded_solver(drone.make_drone_solver, m, batch_scenarios=False,
                                               params=dparams, device="cpu")
    step1, init1 = drone.make_drone_solver(dparams, device="cpu")
    st, st1, err = dinit(13), init1(13), 0.0
    for _ in range(3):
        res, st = dstep(st, dobs)
        res1, st1 = step1(st1, dobs)
        err = max(err, (res.u_seq - res1.u_seq).abs().max().item()
                  / max(1.0, res1.u_seq.abs().max().item()))
    out["drone_philox_err"] = np.array(err)
    st = dinit(13)
    for i in range(n_steps):
        res, st = dstep(st, dobs, inp[f"drone_z_rank{rank}_step{i}"])
        out[f"drone_u_seq_{i}"] = res.u_seq.numpy()
        out[f"drone_xdes_{i}"] = res.xdes.numpy()

    # The drone preset with batch_scenarios=True: 1 and 2 scenarios on this
    # rank's blocks of the JAX sharded solve's normals; all-reduces per solve
    # (plain, adaptive sigma); the Philox solve against the one-rank batch.
    for n_scn in (1, 2):
        tag = f"dbatch{n_scn}"
        bobs = drone.DroneObs(*(torch.tensor(inp[f"{tag}_{n}"]) for n in ("x", "v", "target")))
        bstep, binit = sharded.make_sharded_solver(drone.make_drone_solver, m, params=dparams,
                                                   n_scenarios=n_scn, device="cpu")
        st = binit(9)
        for i in range(n_steps):
            res, st = bstep(st, bobs, inp[f"{tag}_z_rank{rank}_step{i}"])
            out[f"{tag}_u_seq_{i}"] = res.u_seq.numpy()
            out[f"{tag}_xdes_{i}"] = res.xdes.numpy()
        counts = []
        for p in (dparams, dataclasses.replace(dparams, mppi=dataclasses.replace(
                dparams.mppi, adaptive_sigma=True))):
            cstep, cinit = sharded.make_sharded_solver(drone.make_drone_solver, m, params=p,
                                                       n_scenarios=n_scn, device="cpu")
            calls, plain = [], dist.all_reduce
            dist.all_reduce = _counting_all_reduce(calls)
            try:
                cstep(cinit(0), bobs)
            finally:
                dist.all_reduce = plain
            counts.append(len(calls))
        out[f"{tag}_collectives"] = np.array(counts)
        step1, init1 = drone.make_drone_solver(dparams, device="cpu", n_scenarios=n_scn)
        st, st1, err = binit(21), init1(21), 0.0
        for _ in range(3):
            res, st = bstep(st, bobs)
            res1, st1 = step1(st1, bobs)
            err = max(err, (res.u_seq - res1.u_seq).abs().max().item()
                      / max(1.0, res1.u_seq.abs().max().item()))
        out[f"{tag}_philox_err"] = np.array(err)

    # The arm node's plain solve sample-sharded (K=100 as 2 x 50) against the
    # one-rank arm solve on the same seed, three solves.
    from quadrotor_manipulator_mppi_tpu_torch.models import kinova
    from quadrotor_manipulator_mppi_tpu_torch.solver import arm
    from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

    aparams = arm.ArmMPPIParams()
    aobs = arm.ArmObs(q=torch.tensor(kinova.Q_HOME, dtype=torch.float32) + 0.02,
                      qdot=torch.full((7,), 0.05),
                      base_pose=Pose(torch.tensor([0.0, 0.0, 2.1]),
                                     torch.tensor([1.0, 0.0, 0.0, 0.0])),
                      target=arm.default_target())
    astep, ainit = sharded.make_sharded_solver(arm.make_arm_solver, m, batch_scenarios=False,
                                               params=aparams, device="cpu")
    astep1, ainit1 = arm.make_arm_solver(aparams, device="cpu")
    st, st1, err = ainit(4), ainit1(4), 0.0
    for _ in range(3):
        res, st = astep(st, aobs)
        res1, st1 = astep1(st1, aobs)
        for a, b in ((res.u_seq, res1.u_seq), (res.qdes, res1.qdes), (st.u_prev, st1.u_prev)):
            err = max(err, (a - b).abs().max().item() / max(1.0, b.abs().max().item()))
    out["arm_philox_err"] = np.array(err)

    # The flight presets through make_sharded_solver: on this rank's blocks
    # of the JAX sharded solve's normals; on the Philox stream against the
    # one-rank solve; all-reduces per solve.
    for name in ("multirotor", "fixed_wing", "mapped_spheres", "mapped_esdf"):
        for n_scn in (0, 2):
            tag = f"{name}_b{n_scn}"
            make, fparams, fobs = flight_case(name, tag, inp)
            kw = dict(batch_scenarios=bool(n_scn), params=fparams, device="cpu")
            if n_scn:
                kw["n_scenarios"] = n_scn
            fstep, finit = sharded.make_sharded_solver(make, m, **kw)
            st = finit(9)
            for i in range(n_steps):
                res, st = fstep(st, fobs, inp[f"{tag}_z_rank{rank}_step{i}"])
                out[f"{tag}_u_seq_{i}"] = res.u_seq.numpy()
                out[f"{tag}_u_prev_{i}"] = st.u_prev.numpy()
            step1, init1 = make(fparams, device="cpu", n_scenarios=n_scn or None)
            st, st1, err = finit(21), init1(21), 0.0
            for _ in range(3):
                res, st = fstep(st, fobs)
                res1, st1 = step1(st1, fobs)
                err = max(err, (res.u_seq - res1.u_seq).abs().max().item()
                          / max(1.0, res1.u_seq.abs().max().item()))
            out[f"{tag}_philox_err"] = np.array(err)
            calls, plain = [], dist.all_reduce
            dist.all_reduce = _counting_all_reduce(calls)
            try:
                fstep(st, fobs)
            finally:
                dist.all_reduce = plain
            out[f"{tag}_collectives"] = np.array(len(calls))

    # Weak scaling at a tiny size: the JAX function's keys, finite times.
    sc = scaling.measure_weak_scaling(k_per_device=64, h=8, iters=1, device="cpu")
    out["scaling_keys"] = np.array(sorted(sc))
    out["scaling_backend"] = np.array(sc["backend"])
    out["scaling_vals"] = np.array([sc["devices"], sc["global_k_sample_axis"],
                                    sc["t_1dev_ms"], sc["t_sample_sharded_ms"],
                                    sc["t_scenario_sharded_ms"]], dtype=np.float64)

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
