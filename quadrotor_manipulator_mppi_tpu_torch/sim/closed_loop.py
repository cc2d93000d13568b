"""Closed-loop helpers shared by the plant loops.

Port of the JAX package's ``sim/closed_loop.py``: :func:`rpy_of` only, the
plant attitude in the layout the flight controllers consume.  The drone
episode harness of that module comes with the drone loop.
"""

from __future__ import annotations

import torch

from ..models.multirotor import MultirotorState
from ..utils import rotations as rot


def rpy_of(state: MultirotorState) -> torch.Tensor:
    """Plant attitude as (roll, pitch, yaw)."""
    ang = rot.matrix_to_euler(rot.quat_to_matrix(state.quat), "ZYX")
    return torch.stack([ang[..., 2], ang[..., 1], ang[..., 0]], dim=-1)
