"""Softmin sample weighting — the MPPI update's reduction core:
rho = min(S), w = exp(-(S - rho)/lambda) / eta.

Sample-sharded, each rank holds its K-shard and ``group`` is the
``torch.distributed`` group of the sample axis: the reductions become
exactly the JAX package's collectives, in its order — all-reduce MIN of
rho, SUM of eta (which needs the global rho), then SUM of du.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist


def softmin_weights(s: torch.Tensor, lam: float, group: Optional[Any] = None) -> torch.Tensor:
    """Per-sample weights w_k over the sample axis of ``s``: (K,), or
    (B, K) for B scenarios, each row normalised on its own.  With
    ``group``, ``s`` is this rank's K-shard and the min and the sum reduce
    over the group (one collective each, whatever B); the weights sum to 1
    across all ranks."""
    if s.ndim == 1:
        rho = torch.min(s)
    else:
        rho = torch.amin(s, dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(rho, op=dist.ReduceOp.MIN, group=group)
    scaled = torch.exp((rho - s) / lam)
    eta = torch.sum(scaled) if s.ndim == 1 else torch.sum(scaled, dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(eta, op=dist.ReduceOp.SUM, group=group)
    return scaled / eta


def weighted_noise_average(weights: torch.Tensor, noise: torch.Tensor,
                           group: Optional[Any] = None) -> torch.Tensor:
    """du = sum_k w_k * eps_k; noise (K, H, A), weights (K,) -> (H, A), or
    per scenario: noise (B, K, H, A), weights (B, K) -> (B, H, A).  With
    ``group``, the sum of the ranks' partial sums (the third and last
    collective of a solve)."""
    du = torch.einsum("k,kha->ha" if weights.ndim == 1 else "bk,bkha->bha", weights, noise)
    if group is not None:
        dist.all_reduce(du, op=dist.ReduceOp.SUM, group=group)
    return du
