"""Multi-process bring-up: ``torch.distributed`` initialisation and each
rank's share of the scenarios.

Port of the JAX package's ``parallel/multihost.py``.  Every rank runs the
same program:

    from quadrotor_manipulator_mppi_tpu_torch.parallel import mesh, multihost
    multihost.initialize(backend="nccl")         # under torchrun; no-op alone
    m = mesh.make_mesh(n_sample_shards=2, n_scenario_shards=2)
    ...sharded.make_sharded_solver(..., mesh=m)...
    obs = multihost.host_local_scenarios(m, global_obs)

The caller names the backend: ``"nccl"`` when each rank has its own card,
``"gloo"`` for CPU tensors and for several ranks on one card (NCCL refuses
two ranks on one device).  Nothing switches backends on its own.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> dict:
    """Join the process group if this is a multi-process run.

    Explicit arguments win (``init_method`` such as
    ``"tcp://localhost:29500"``, with ``world_size`` and ``rank``, each
    falling back to ``WORLD_SIZE``/``RANK``).  Otherwise torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) selects ``env://``.  With neither this is a single process
    and nothing happens.  A second call never initialises again.  Returns
    the topology."""
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is not None and not dist.is_initialized():
        if backend is None:
            raise ValueError(
                "name the backend: 'nccl' when each rank has its own card, "
                "'gloo' for CPU tensors or several ranks on one card"
            )
        if world_size is None and "WORLD_SIZE" in env:
            world_size = int(env["WORLD_SIZE"])
        if rank is None and "RANK" in env:
            rank = int(env["RANK"])
        kwargs = {"backend": backend, "init_method": init_method}
        if world_size is not None:
            kwargs["world_size"] = world_size
        if rank is not None:
            kwargs["rank"] = rank
        dist.init_process_group(**kwargs)
    if dist.is_initialized():
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
                "backend": dist.get_backend(), "initialized": True}
    return {"rank": 0, "world_size": 1, "backend": None, "initialized": False}


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor or array leaf of nested NamedTuples, tuples,
    lists and dicts (the observation and state types); other leaves pass."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def host_local_scenarios(mesh, global_batch: Any) -> Any:
    """This rank's slice of the scenario axis: every tensor or array leaf
    of ``global_batch`` carries a leading GLOBAL scenario axis, divided
    evenly over the mesh's scenario rows."""
    n_rows, row = mesh.n_scenario_shards, mesh.scenario_index

    def take(x):
        n = x.shape[0]
        if n % n_rows:
            raise ValueError(f"{n} scenarios not divisible by {n_rows} scenario shards")
        per = n // n_rows
        return x[row * per:(row + 1) * per]

    return tree_map(take, global_batch)
