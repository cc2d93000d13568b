"""Pose container: position + unit quaternion (wxyz, scalar-first)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rotations as rot


class Pose(NamedTuple):
    position: torch.Tensor   # [..., 3]
    quat: torch.Tensor       # [..., 4] wxyz

    @classmethod
    def from_xyzw(cls, position: torch.Tensor, quat_xyzw: torch.Tensor) -> "Pose":
        """Build from a ROS-order quaternion (geometry_msgs layout)."""
        return cls(position=position, quat=rot.quat_from_xyzw(quat_xyzw))
