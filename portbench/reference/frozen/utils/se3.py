"""Batched rigid transforms as ``(R, p)`` pairs.

Port of the JAX package's ``utils/se3.py``: a transform is a rotation
``[..., 3, 3]`` and a translation ``[..., 3]`` (not a 4x4 homogeneous
matrix); fixed, revolute and prismatic joint transforms, the xyz+rpy and
xyz+quat constructors, and the so(3) hat and vee maps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rotations import euler_to_matrix, matvec, quat_from_axis_angle, quat_to_matrix

Tensor = torch.Tensor


class Transform(NamedTuple):
    """Rigid transform: rotation [..., 3, 3], translation [..., 3]."""

    rot: Tensor
    trans: Tensor

    @property
    def batch_shape(self):
        return self.trans.shape[:-1]

    def compose(self, other: "Transform") -> "Transform":
        """self @ other (``other`` applied first, in the child frame)."""
        return Transform(rot=self.rot @ other.rot, trans=self.trans + matvec(self.rot, other.trans))

    def apply(self, points: Tensor) -> Tensor:
        """Transform points [..., 3]."""
        return matvec(self.rot, points) + self.trans

    def inverse(self) -> "Transform":
        rt = self.rot.transpose(-1, -2)
        return Transform(rot=rt, trans=-matvec(rt, self.trans))

    def to_homogeneous(self) -> Tensor:
        """[..., 4, 4] homogeneous matrix (interop and tests)."""
        bottom = torch.zeros(self.batch_shape + (1, 4), dtype=self.trans.dtype,
                             device=self.trans.device)
        bottom[..., 0, 3] = 1.0
        top = torch.cat([self.rot, self.trans[..., :, None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> Transform:
    batch_shape = tuple(batch_shape)
    eye = torch.eye(3, dtype=dtype, device=device)
    return Transform(rot=eye.expand(batch_shape + (3, 3)).clone(),
                     trans=torch.zeros(batch_shape + (3,), dtype=dtype, device=device))


def from_homogeneous(m: Tensor) -> Transform:
    return Transform(rot=m[..., :3, :3], trans=m[..., :3, 3])


def from_xyz_rpy(xyz: Tensor, rpy: Tensor) -> Transform:
    """URDF-style origin: translation + roll/pitch/yaw (extrinsic XYZ ==
    intrinsic ZYX: R = Rz(yaw) Ry(pitch) Rx(roll))."""
    angles = torch.stack([rpy[..., 2], rpy[..., 1], rpy[..., 0]], dim=-1)
    return Transform(rot=euler_to_matrix(angles, "ZYX"), trans=xyz)


def from_xyz_quat(xyz: Tensor, quat_wxyz: Tensor) -> Transform:
    return Transform(rot=quat_to_matrix(quat_wxyz), trans=xyz)


def revolute(origin: Transform, axis: Tensor, q: Tensor) -> Transform:
    """Joint transform: the fixed origin, then a rotation of ``q`` about the
    local ``axis`` (``q`` of any batch shape; the origin broadcasts)."""
    rot_q = quat_to_matrix(quat_from_axis_angle(axis * q[..., None]))
    return Transform(rot=origin.rot @ rot_q, trans=origin.trans.expand(q.shape + (3,)))


def prismatic(origin: Transform, axis: Tensor, q: Tensor) -> Transform:
    """The fixed origin, then a translation of ``q`` along the local
    ``axis``."""
    disp = matvec(origin.rot, axis) * q[..., None]
    return Transform(rot=origin.rot.expand(q.shape + (3, 3)), trans=origin.trans + disp)


def skew(v: Tensor) -> Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def unskew(m: Tensor) -> Tensor:
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)
