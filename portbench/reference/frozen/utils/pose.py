"""Pose container: position + unit quaternion (wxyz, scalar-first)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rotations as rot
from .se3 import Transform

Tensor = torch.Tensor


class Pose(NamedTuple):
    position: Tensor   # [..., 3]
    quat: Tensor       # [..., 4] wxyz

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        batch_shape = tuple(batch_shape)
        one = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
        return cls(position=torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
                   quat=one.expand(batch_shape + (4,)).clone())

    @classmethod
    def from_xyzw(cls, position: Tensor, quat_xyzw: Tensor) -> "Pose":
        """Build from a ROS-order quaternion (geometry_msgs layout)."""
        return cls(position=position, quat=rot.quat_from_xyzw(quat_xyzw))

    @classmethod
    def from_transform(cls, t: Transform) -> "Pose":
        return cls(position=t.trans, quat=rot.matrix_to_quat(t.rot))

    def to_transform(self) -> Transform:
        return Transform(rot=rot.quat_to_matrix(self.quat), trans=self.position)

    @property
    def rotation_matrix(self) -> Tensor:
        return rot.quat_to_matrix(self.quat)

    def compose(self, other: "Pose") -> "Pose":
        return Pose(position=self.position + rot.quat_rotate(self.quat, other.position),
                    quat=rot.quat_multiply(self.quat, other.quat))

    def inverse(self) -> "Pose":
        qc = rot.quat_conjugate(self.quat)
        return Pose(position=-rot.quat_rotate(qc, self.position), quat=qc)


def position_error_l1(a: Pose, b: Pose) -> Tensor:
    """Sum of absolute position differences: the reference's reach metric
    (threshold 0.005 m)."""
    return torch.sum(torch.abs(a.position - b.position), dim=-1)


def orientation_error_vec(a: Pose, b: Pose) -> Tensor:
    """Rotation error vector log(Ra^T Rb), [..., 3]."""
    return rot.so3_error(a.rotation_matrix, b.rotation_matrix)
