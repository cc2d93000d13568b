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
carries the seed and the solve index as host integers, or as int64 device
tensors (a captured CUDA graph advances the index on the card); either
draws the same noise.

A step built with ``n_scenarios=B`` solves B independent problems at once,
as ``jax.vmap`` of the JAX step does: every state field, ``z`` and the
outputs carry a leading B, the keys are a (B,) int64 device tensor, and
each scenario's weights, du and adaptive sigma are its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import sampling, weights as weights_ops
from ..utils import savgol
from ..utils.device import device_const, resolve_device

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
    u_prev: Tensor  # (H, A) warm-start control sequence; (B, H, A) for a batch
    sigma: Tensor   # (A,) live per-action exploration std (or (A, A)); (B, A)
    seed: Any       # 64-bit Philox key: an int, or a (1,) int64 tensor
                    # (``philox_keys``); for a batch a (B,) int64 tensor of keys
    step: Any       # solve index, the first Philox counter word: an int, or an
                    # int64 device tensor, (1,) or one per scenario (B,)


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


def init_state(config: MPPIConfig, seed, dtype=torch.float32, device="cuda",
               n_scenarios: Optional[int] = None) -> MPPIState:
    """Zero warm start (H, A), the configured sigma as the live sigma, the
    Philox seed and solve index 0.  With ``n_scenarios=B``: every field with
    a leading B, and ``seed`` B seeds, kept as a (B,) int64 key tensor on
    ``device``."""
    dev = resolve_device(device)
    u_prev = torch.zeros((config.n_horizon, config.n_action), dtype=dtype, device=dev)
    sigma = _diag_sigma(config, dtype, dev)
    if n_scenarios is None:
        return MPPIState(u_prev=u_prev, sigma=sigma, seed=int(seed), step=0)
    return scenario_state(u_prev, sigma, seed, n_scenarios)


def scenario_state(u_prev: Tensor, sigma: Tensor, seed, n_scenarios: int) -> MPPIState:
    """The state of ``n_scenarios`` problems that all start from ``u_prev``
    and ``sigma``: both repeated along a leading axis, and ``seed`` B seeds,
    as a (B,) int64 key tensor on ``u_prev``'s device."""
    seeds = [int(x) for x in seed]
    if len(seeds) != n_scenarios:
        raise ValueError(f"{len(seeds)} seeds for {n_scenarios} scenarios")
    return MPPIState(
        u_prev=u_prev.expand(n_scenarios, *u_prev.shape).clone(),
        sigma=sigma.expand(n_scenarios, *sigma.shape).clone(),
        seed=torch.tensor(seeds, dtype=torch.int64, device=u_prev.device), step=0,
    )


def scenario_lift(n_scenarios: Optional[int]) -> Callable[[Tensor, int], Tensor]:
    """``lift(x, n)`` for a task's cost: a per-scenario field (B, ...) with
    ``n`` unit axes inserted after B, to meet (B, K, H, ...) samples; the
    identity for one problem (``n_scenarios=None``)."""
    if n_scenarios is None:
        return lambda x, n: x
    return lambda x, n: x.reshape(x.shape[:1] + (1,) * n + x.shape[1:])


def device_counters(state: MPPIState, device) -> MPPIState:
    """``state`` with its Philox key and solve index as int64 tensors on
    ``device`` (``sampling.philox_keys``, ``sampling.step_tensor``), as a
    captured CUDA graph reads them; they draw the same noise as the ints."""
    return state._replace(seed=sampling.philox_keys(state.seed, device),
                          step=sampling.step_tensor(state.step, device))


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
    smooth du, add, clamp, then the warm start (shift and decay).  Leading
    scenario axes broadcast.  Returns (u, warm)."""
    if smoother is not None:
        du = torch.matmul(smoother, du)
    u = u_prev + du
    if lo is not None or hi is not None:
        u = torch.clamp(u, min=lo, max=hi)
    warm = torch.cat([u[..., 1:, :], u[..., -1:, :]], dim=-2) if config.shift_warm_start else u
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
    group: Optional[Any] = None, n_local_samples: Optional[int] = None,
    n_scenarios: Optional[int] = None,
) -> Callable[..., Tuple[Tensor, MPPIState]]:
    """Build the plain solve step (any device; no kernels).

    Sample-sharded (``group``: the ``torch.distributed`` group of the
    sample axis; ``n_local_samples``: this rank's share of
    ``config.n_samples``), each rank draws its K-shard of the Philox stream
    at global sample offset (group rank) * n_local_samples, and the
    reductions become the group's collectives (``ops/weights``, plus the
    SUM of m2 with adaptive sigma).  A ``z`` passed in is then this rank's
    (n_local_samples, H, A) block.

    ``n_scenarios=B`` batches B problems: ``state.u_prev`` (B, H, A),
    ``state.sigma`` (B, A) (or (B, A, A)), ``state.seed`` a (B,) int64 key
    tensor, ``z`` (B, K, H, A); ``rollout_fn`` and ``cost_fn`` get v
    (B, K, H, A) and the batched ``obs`` and return per-sample costs
    (B, K).  The collectives run on the batched tensors, so a solve makes
    as many as one unbatched solve."""
    if config.adaptive_sigma and config.sigma_scale_fn is not None:
        raise ValueError("adaptive_sigma and sigma_scale_fn are exclusive")
    k, h, a = n_local_samples or config.n_samples, config.n_horizon, config.n_action
    batched = n_scenarios is not None
    k_off = 0 if group is None else dist.get_rank(group) * k
    # Host constants of the tail, copied to the state's device once
    # (device_const), so a step on the card never waits for a host copy.
    smoother = (savgol.savgol_matrix(h, config.savgol_window, config.savgol_polyorder)
                if config.savgol_window else None)
    bounds = [None if b is None else np.broadcast_to(np.asarray(b, np.float64), (a,))
              for b in (config.u_min, config.u_max)]
    nominal = np.broadcast_to(np.asarray(
        0.0 if config.nominal_action is None else config.nominal_action, np.float64), (h, a))
    sigma_base = _diag_sigma(config, torch.float64).numpy() if config.adaptive_sigma else None

    def check(state: MPPIState) -> None:
        want = (n_scenarios, h, a)
        if tuple(state.u_prev.shape) != want or not isinstance(state.seed, Tensor) \
                or tuple(state.seed.shape) != (n_scenarios,) or state.sigma.shape[0] != n_scenarios:
            raise ValueError(
                f"a step built for {n_scenarios} scenarios takes u_prev {want}, sigma with a "
                f"leading {n_scenarios} and a ({n_scenarios},) key tensor; got u_prev "
                f"{tuple(state.u_prev.shape)}, sigma {tuple(state.sigma.shape)}, seed "
                f"{tuple(state.seed.shape) if isinstance(state.seed, Tensor) else state.seed!r}")

    def step(state: MPPIState, obs: Any, z=None) -> Tuple[Tensor, MPPIState]:
        dev, dtype = state.u_prev.device, state.u_prev.dtype
        if batched:
            check(state)

        def const(x):
            return None if x is None else device_const(x, state.u_prev)

        sigma_live = state.sigma
        if config.sigma_scale_fn is not None:
            sigma_live = sigma_live * config.sigma_scale_fn(obs)
        if z is None:
            z = sampling.philox_normals(state.seed, state.step, k, h, a, dev,
                                        sample_offset=k_off)
            if not batched and z.ndim == 4:  # one problem under a (1,) key tensor
                z = z[0]
            z = z.permute(0, 3, 2, 1) if batched else z.permute(2, 1, 0)
        z = torch.as_tensor(z, dtype=dtype, device=dev)
        noise = sampling.sample_noise(z, sigma_live, batched)
        if config.zero_mean_noise:
            noise = sampling.zero_mean_trick(noise)

        v = state.u_prev[..., None, :, :] + noise
        s = cost_fn(rollout_fn(v, obs), v, state.u_prev, obs)
        w = weights_ops.softmin_weights(s, config.lam, group)
        du = weights_ops.weighted_noise_average(w, noise, group)
        u, warm = update_tail(config, state.u_prev, du, const(smoother), const(bounds[0]),
                              const(bounds[1]), const(nominal))

        sigma_next = state.sigma
        if config.adaptive_sigma:
            m2 = torch.einsum("bk,bkha->ba" if batched else "k,kha->a", w, noise * noise) / h
            if group is not None:
                dist.all_reduce(m2, op=dist.ReduceOp.SUM, group=group)
            sigma_next = adapt_sigma(config, state.sigma, m2, const(sigma_base))
        return u, MPPIState(u_prev=warm, sigma=sigma_next, seed=state.seed,
                            step=state.step + 1)

    return step
