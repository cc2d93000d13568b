"""Kinematic double integration along the horizon axis, and a sequential
rollout of true dynamics over the horizon."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def double_integrate(
    accel: torch.Tensor, q0: torch.Tensor, v0: torch.Tensor, dt: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """accel: [..., H, A]; q0, v0: broadcastable to [..., A].  Returns
    (q, v), each [..., H, A], with the reference's update
    q[t] = q[t-1] + v[t-1]*dt + 0.5*a[t]*dt^2,  v[t] = v[t-1] + a[t]*dt,
    realized as prefix sums so the horizon axis stays parallel."""
    v0b = torch.as_tensor(v0)[..., None, :]
    q0b = torch.as_tensor(q0)[..., None, :]
    v = torch.cumsum(accel * dt, dim=-2) + v0b
    v_prev = torch.cat([v0b.expand(v[..., :1, :].shape), v[..., :-1, :]], dim=-2)
    dq = v_prev * dt + 0.5 * accel * dt * dt
    q = torch.cumsum(dq, dim=-2) + q0b
    return q, v


def scan_rollout(
    step: Callable[[Any, torch.Tensor], Any],
    x0: Any,
    u_seq: torch.Tensor,
    extract: Callable[[Any], Any] = lambda s: s,
):
    """Roll ``step(state, u_t) -> next_state`` over the horizon (axis 0 of
    ``u_seq``, [H, K, ...]; the state's leaves carry the K axis): a loop over
    the horizon, the counterpart of ``lax.scan``.  Returns the per-step
    ``extract(next_state)`` stacked with the horizon first (a tensor, or a
    tuple / NamedTuple of tensors)."""
    ys, state = [], x0
    for u_t in u_seq:
        state = step(state, u_t)
        ys.append(extract(state))
    first = ys[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(ys)
    stacked = [torch.stack(leaves) for leaves in zip(*ys)]
    return type(first)(*stacked) if hasattr(first, "_fields") else type(first)(stacked)
