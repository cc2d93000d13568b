"""The functional MPPI engine — the plain PyTorch pipeline.

Port of the JAX package's ``solver/mppi.py``: a step built once from a
static :class:`MPPIConfig` plus two task callables (rollout and cost),

    step(state, obs, z=None) -> (u_seq, new_state)

sample noise -> v = u_prev + eps -> rollout -> per-sample cost S ->
softmin weights -> du = sum_k w_k eps_k -> Savitzky-Golay smooth ->
u = u_prev + du -> clamp -> warm start.

Randomness is explicit: ``z`` (standard normals, (K, H, A)) when the caller
supplies it, else the Philox stream of ``(state.seed, state.step)``
(``ops/sampling.py``), which the CUDA kernels draw too.  The solver state
carries the seed and the solve index as host integers, so advancing it costs
no device work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..ops import sampling, weights as weights_ops
from ..utils import savgol

Tensor = torch.Tensor


@dataclass(frozen=True)
class MPPIConfig:
    """Static solver hyperparameters — the JAX package's fields, unchanged."""

    n_samples: int = 100
    n_horizon: int = 32
    n_action: int = 7
    dt: float = 0.01
    lam: float = 0.1
    sigma: Any = 0.1              # scalar | (A,) | (A, A)
    savgol_window: int = 9        # 0 disables smoothing
    savgol_polyorder: int = 2
    shift_warm_start: bool = False
    u_min: Optional[Any] = None
    u_max: Optional[Any] = None
    zero_mean_noise: bool = False
    warm_start_decay: float = 1.0
    nominal_action: Optional[Any] = None  # (A,) or (H, A); default zeros
    adaptive_sigma: bool = False
    adapt_beta: float = 0.1
    sigma_min_scale: float = 0.3
    sigma_max_scale: float = 3.0
    sigma_scale_fn: Optional[Callable[[Any], Tensor]] = None


class MPPIState(NamedTuple):
    u_prev: Tensor  # (H, A) warm-start control sequence
    sigma: Tensor   # (A,) live per-action exploration std (or (A, A))
    seed: int       # 64-bit Philox key
    step: int       # solve index: the first Philox counter word


def _diag_sigma(config: MPPIConfig, dtype=torch.float32, device=None) -> Tensor:
    """The live sigma stored in MPPIState: scalar -> (A,) diag; (A,) as is;
    a full (A, A) matrix as is (incompatible with adaptive sigma)."""
    s = torch.as_tensor(config.sigma, dtype=dtype).to(device)
    if s.ndim == 0:
        return torch.full((config.n_action,), float(s), dtype=dtype, device=device)
    if s.ndim == 1:
        return s
    if config.adaptive_sigma:
        raise ValueError("adaptive_sigma requires scalar or diagonal sigma")
    return s


def action_bounds(config: MPPIConfig, dtype=torch.float32, device=None):
    """(lo, hi) clamp tensors of shape (A,), None where unbounded."""
    def bound(b):
        if b is None:
            return None
        return torch.as_tensor(b, dtype=dtype).to(device).expand(config.n_action)
    return bound(config.u_min), bound(config.u_max)


def nominal_sequence(config: MPPIConfig, dtype=torch.float32, device=None) -> Tensor:
    """The warm-start reversion target as an (H, A) tensor."""
    shape = (config.n_horizon, config.n_action)
    if config.nominal_action is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.as_tensor(config.nominal_action, dtype=dtype).to(device).expand(shape).clone()


def update_tail(
    config: MPPIConfig, u_prev: Tensor, du: Tensor, smoother: Optional[Tensor],
    lo: Optional[Tensor], hi: Optional[Tensor], nominal: Tensor,
) -> Tuple[Tensor, Tensor]:
    """The (H, A) tail shared by the plain pipeline and the kernel step:
    smooth du, add, clamp, then the warm start (shift and decay).
    Returns (u, warm)."""
    if smoother is not None:
        du = torch.matmul(smoother, du)
    u = u_prev + du
    if lo is not None or hi is not None:
        u = torch.clamp(u, min=lo, max=hi)
    warm = torch.cat([u[1:], u[-1:]], dim=0) if config.shift_warm_start else u
    if config.warm_start_decay < 1.0:
        warm = nominal + config.warm_start_decay * (warm - nominal)
    return u, warm


def adapt_sigma(config: MPPIConfig, sigma: Tensor, m2: Tensor, base: Tensor) -> Tensor:
    """CVIS-style diagonal adaptation from the weighted second moment m2."""
    var = (1.0 - config.adapt_beta) * sigma**2 + config.adapt_beta * m2
    return torch.minimum(
        torch.maximum(torch.sqrt(var), config.sigma_min_scale * base),
        config.sigma_max_scale * base,
    )


def make_step(
    config: MPPIConfig, rollout_fn: Callable, cost_fn: Callable,
) -> Callable[..., Tuple[Tensor, MPPIState]]:
    """Build the plain solve step (any device; no kernels)."""
    if config.adaptive_sigma and config.sigma_scale_fn is not None:
        raise ValueError("adaptive_sigma and sigma_scale_fn are exclusive")
    k, h, a = config.n_samples, config.n_horizon, config.n_action

    def step(state: MPPIState, obs: Any, z=None) -> Tuple[Tensor, MPPIState]:
        dev, dtype = state.u_prev.device, state.u_prev.dtype
        sigma_live = state.sigma
        if config.sigma_scale_fn is not None:
            sigma_live = sigma_live * config.sigma_scale_fn(obs)
        if z is None:
            z = sampling.philox_normals(state.seed, state.step, k, h, a, dev).permute(2, 1, 0)
        z = torch.as_tensor(z, dtype=dtype, device=dev)
        noise = sampling.sample_noise(z, sigma_live)
        if config.zero_mean_noise:
            noise = sampling.zero_mean_trick(noise)

        v = state.u_prev[None] + noise
        s = cost_fn(rollout_fn(v, obs), v, state.u_prev, obs)
        w = weights_ops.softmin_weights(s, config.lam)
        du = weights_ops.weighted_noise_average(w, noise)
        smoother = None
        if config.savgol_window:
            smoother = torch.as_tensor(
                savgol.savgol_matrix(h, config.savgol_window, config.savgol_polyorder),
                dtype=dtype, device=dev,
            )
        lo, hi = action_bounds(config, dtype, dev)
        u, warm = update_tail(config, state.u_prev, du, smoother, lo, hi,
                              nominal_sequence(config, dtype, dev))

        sigma_next = state.sigma
        if config.adaptive_sigma:
            m2 = torch.einsum("k,kha->a", w, noise * noise) / h
            sigma_next = adapt_sigma(config, state.sigma, m2, _diag_sigma(config, dtype, dev))
        return u, MPPIState(u_prev=warm, sigma=sigma_next, seed=state.seed,
                            step=state.step + 1)

    return step
