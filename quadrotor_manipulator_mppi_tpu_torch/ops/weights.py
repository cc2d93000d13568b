"""Softmin sample weighting — the MPPI update's reduction core:
rho = min(S), w = exp(-(S - rho)/lambda) / eta."""

from __future__ import annotations

import torch


def softmin_weights(s: torch.Tensor, lam: float) -> torch.Tensor:
    """Per-sample weights w_k over the leading sample axis of ``s`` (K,)."""
    scaled = torch.exp((torch.min(s) - s) / lam)
    return scaled / torch.sum(scaled)


def weighted_noise_average(weights: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """du = sum_k w_k * eps_k; noise (K, H, A), weights (K,) -> (H, A)."""
    return torch.einsum("k,kha->ha", weights, noise)
