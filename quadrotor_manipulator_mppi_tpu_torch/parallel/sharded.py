"""Sharded MPPI solvers over a (scenario, sample) mesh.

Port of the JAX package's ``parallel/sharded.py``.  The sample-sharded
solve runs the same step as the one-rank solve: each rank draws only its
K-shard of the noise and the sample-axis reductions become the sample
group's collectives.  Scenario batches ride a leading axis on top (one
kernel launch per pass for the whole batch) and split over the scenario
rows with no communication at all.

Equivalence: each rank draws the Philox stream at its GLOBAL sample
indices (``ops/sampling.py``), so an n-shard solve draws exactly the
one-rank noise set and equals the one-rank solve on the same seed up to
summation order, for any shard count.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .mesh import SAMPLE_AXIS, SCENARIO_AXIS, Mesh


def make_sharded_solver(
    make_step_fn: Callable[..., Tuple[Callable, Callable]],
    mesh: Mesh,
    batch_scenarios: bool = True,
    n_scenarios: Optional[int] = None,
    **preset_kwargs,
):
    """Shard a task preset (``solver/whole_body.make_whole_body_solver``).

    ``make_step_fn(group=..., n_local_samples=..., n_scenarios=...,
    **kwargs)`` must return ``(step, init)``; its config's ``n_samples`` is
    the GLOBAL sample count, divided over the mesh's sample axis.

    With ``batch_scenarios``, ``n_scenarios`` (default: one per scenario
    row) GLOBAL scenarios are divided over the scenario rows; the returned
    ``step(states, obs, z=None)`` takes this rank's scenarios with a
    leading axis (``multihost.host_local_scenarios``), and ``init(seed)``
    gives this rank's states with the keys of ``scenario_seeds(seed,
    n_scenarios)``, so a scenario's solve does not depend on the layout."""
    n_smp = mesh.shape[SAMPLE_AXIS]
    params = preset_kwargs.get("params")
    if params is None:
        raise ValueError(
            "make_sharded_solver requires explicit params= so the GLOBAL "
            "n_samples can be divided over the sample shards (omitting it "
            "would silently multiply the sample count by the shard count)"
        )
    total_k = params.mppi.n_samples
    if total_k % n_smp:
        raise ValueError(f"n_samples {total_k} not divisible by {n_smp} shards")
    n_rows = mesh.shape[SCENARIO_AXIS]
    n_global = n_local = None
    if batch_scenarios:
        n_global = n_rows if n_scenarios is None else n_scenarios
        if n_global % n_rows:
            raise ValueError(f"{n_global} scenarios not divisible by {n_rows} scenario shards")
        n_local = n_global // n_rows
    step, init = make_step_fn(group=mesh.sample_group, n_local_samples=total_k // n_smp,
                              n_scenarios=n_local, **preset_kwargs)
    if not batch_scenarios:
        return step, init

    def sharded_init(seed: int, **kwargs):
        row = mesh.scenario_index
        return init(scenario_seeds(seed, n_global)[row * n_local:(row + 1) * n_local], **kwargs)

    return step, sharded_init


def scenario_seeds(seed: int, n_scenarios: int) -> list:
    """Independent 63-bit Philox keys per scenario from one seed (NumPy's
    ``SeedSequence``): the counterpart of ``scenario_keys``."""
    words = np.random.SeedSequence(int(seed)).generate_state(n_scenarios, dtype=np.uint64)
    return [int(w) >> 1 for w in words]
