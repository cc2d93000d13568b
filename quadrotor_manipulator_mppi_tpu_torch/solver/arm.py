"""Arm MPPI preset: only the reference's demo target is ported so far."""

from __future__ import annotations

import torch

from ..utils.pose import Pose


def default_target(dtype=torch.float32, device=None) -> Pose:
    """The reference's hardcoded demo target, its xyzw-stored quaternion
    read as the ROS layout it is."""
    return Pose.from_xyzw(
        torch.tensor([0.1029, 0.4055, 1.6498], dtype=dtype, device=device),
        torch.tensor([-0.5, -0.5, 0.5, -0.5], dtype=dtype, device=device),
    )
