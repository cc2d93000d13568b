"""Kinematic double integration along the horizon axis."""

from __future__ import annotations

from typing import Tuple

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
