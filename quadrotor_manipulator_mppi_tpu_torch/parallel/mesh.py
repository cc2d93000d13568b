"""The (scenario, sample) layout of a sharded solve over ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py``.  Two axes:

* ``sample`` — the MPPI rollouts (K) of one problem, reduced by exactly
  three collectives per solve (MIN of rho, SUM of eta, SUM of du;
  ``ops/weights.py``), four with adaptive sigma;
* ``scenario`` — independent problems, with no communication at all.

Rank r sits at scenario row r // n_sample_shards and sample column
r % n_sample_shards; each scenario row gets its own process group over its
sample column, so the collectives of one row never wait on another.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

SAMPLE_AXIS = "sample"
SCENARIO_AXIS = "scenario"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the layout.  ``sample_group`` is the process
    group of its scenario row, or None when a row has one rank (nothing to
    reduce)."""

    n_scenario_shards: int
    n_sample_shards: int
    rank: int
    scenario_index: int
    sample_index: int
    sample_group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {SCENARIO_AXIS: self.n_scenario_shards, SAMPLE_AXIS: self.n_sample_shards}


def make_mesh(n_sample_shards: Optional[int] = None, n_scenario_shards: int = 1) -> Mesh:
    """The mesh over the initialised ``torch.distributed`` world.  Defaults
    to all ranks on the sample axis (the latency-optimal layout for one
    control problem).  Every rank must call it, with the same arguments:
    it creates one process group per scenario row."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed world: call "
            "parallel.multihost.initialize(...) or torch.distributed.init_process_group first"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_sample_shards is None:
        n_sample_shards = world // n_scenario_shards
    if n_sample_shards * n_scenario_shards != world:
        raise ValueError(f"{n_scenario_shards} x {n_sample_shards} != {world} ranks")
    row, col = divmod(rank, n_sample_shards)
    group = None
    if n_sample_shards > 1:
        for r in range(n_scenario_shards):
            g = dist.new_group(ranks=list(range(r * n_sample_shards, (r + 1) * n_sample_shards)))
            if r == row:
                group = g
    return Mesh(n_scenario_shards=n_scenario_shards, n_sample_shards=n_sample_shards,
                rank=rank, scenario_index=row, sample_index=col, sample_group=group)
