"""Weak-scaling efficiency over the ranks of a ``torch.distributed`` world.

Port of the JAX package's ``parallel/scaling.py``: time the whole-body
solve (a) on one rank, (b) sample-sharded over all ranks at the same
per-rank K (the softmin collectives are the only communication), (c)
scenario-sharded (one independent problem per rank, no communication).
Every rank of an initialised world calls it; each returns its own
timings.  On the card the times come from CUDA events, on the CPU from the
host clock.  ``backend`` is the whole-body solver's: ``"cuda"`` (the
kernels, the JAX ``"pallas"``) or ``"torch"`` (the plain pipeline, the JAX
``"xla"``); the result's ``"backend"`` field names it, as the JAX field
does.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def measure_weak_scaling(k_per_device: int = 2048, h: int = 50, iters: int = 10,
                         device="cuda", noise_spill: bool = True,
                         backend: str = "cuda") -> dict:
    from ..solver import whole_body as wbs
    from ..solver.mppi import MPPIConfig
    from . import mesh as mesh_mod
    from .multihost import tree_map
    from .sharded import make_sharded_solver

    dev = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1

    def mk_params(k_total):
        return wbs.WholeBodyMPPIParams(
            mppi=MPPIConfig(
                n_samples=k_total, n_horizon=h, n_action=wbs.N_ACTIONS,
                dt=0.01, lam=0.1, sigma=wbs.default_sigma(), savgol_window=9,
            )
        )

    def bench(fn) -> float:
        for _ in range(2):
            fn()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3

    obs1 = wbs.default_obs(device=dev)
    one = tree_map(lambda x: x[None], obs1)
    common = dict(device=dev, backend=backend, noise_spill=noise_spill, low_k_guard="off")

    # One rank at the per-rank problem size.
    step1, init1 = wbs.make_whole_body_solver(mk_params(k_per_device), **common)
    st1 = init1(0)
    t1 = bench(lambda: step1(st1, obs1))

    # Weak scaling over the sample axis.
    mesh_s = mesh_mod.make_mesh(n_sample_shards=n, n_scenario_shards=1)
    step_s, init_s = make_sharded_solver(wbs.make_whole_body_solver, mesh_s,
                                         params=mk_params(k_per_device * n), **common)
    st_s = init_s(0)
    t_sample = bench(lambda: step_s(st_s, one))

    # Weak scaling over the scenario axis (communication-free).
    mesh_c = mesh_mod.make_mesh(n_sample_shards=1, n_scenario_shards=n)
    step_c, init_c = make_sharded_solver(wbs.make_whole_body_solver, mesh_c,
                                         params=mk_params(k_per_device), n_scenarios=n,
                                         **common)
    st_c = init_c(0)
    t_scn = bench(lambda: step_c(st_c, one))

    return {
        "devices": n,
        "backend": backend,
        "k_per_device": k_per_device,
        "h": h,
        "t_1dev_ms": t1,
        "t_sample_sharded_ms": t_sample,
        "t_scenario_sharded_ms": t_scn,
        # Weak-scaling efficiency: same per-rank work, ideal ratio 1.0.
        "weak_eff_sample_axis": t1 / t_sample,
        "weak_eff_scenario_axis": t1 / t_scn,
        "global_k_sample_axis": k_per_device * n,
        "global_solves_per_s_scenario_axis": n * 1e3 / t_scn,
    }
