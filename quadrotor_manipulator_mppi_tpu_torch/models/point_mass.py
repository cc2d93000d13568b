"""Point-mass double-integrator plant: the drone MPPI's internal model.

Port of the JAX package's ``models/point_mass.py``.  The batched
closed-form rollout lives in ``ops/integrators.double_integrate``; this is
the single-step form the kernel solve's closed loops step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class PointMassState(NamedTuple):
    pos: Tensor
    vel: Tensor


def step(state: PointMassState, accel: Tensor, dt: float) -> PointMassState:
    """p += v dt + a dt^2 / 2 with the previous velocity, then v += a dt."""
    pos = state.pos + state.vel * dt + 0.5 * accel * dt * dt
    vel = state.vel + accel * dt
    return PointMassState(pos=pos, vel=vel)
