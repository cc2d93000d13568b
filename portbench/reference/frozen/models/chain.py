"""Static kinematic-chain specification and batched FK.

Port of the JAX package's ``models/chain.py``.  The chain is compiled once
on the host into a :class:`ChainSpec` of float64 NumPy arrays, fixed
origins pre-composed into the next actuated joint.  The quaternion FK
(``*_posquat``, the solvers' path) keeps every chain constant a Python
float, so a call moves no constant to the device and runs elementwise on
any batch shape.  The matrix FK (:func:`forward_kinematics`,
:func:`link_transforms` on ``utils/se3.Transform``) is the oracle the
quaternion path is held against; its 3x3 constants are copied to the
device once (``device_const``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import rotations as rot
from ..utils import se3
from ..utils.device import device_const

Tensor = torch.Tensor

REVOLUTE = 0
PRISMATIC = 1


def matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion, host-side float64 (Shepperd)."""
    t = np.trace(m)
    cands = np.array([1 + t, 1 + m[0, 0] - m[1, 1] - m[2, 2],
                      1 - m[0, 0] + m[1, 1] - m[2, 2],
                      1 - m[0, 0] - m[1, 1] + m[2, 2]])
    i = int(np.argmax(cands))
    s = 2.0 * np.sqrt(max(cands[i], 1e-12))
    if i == 0:
        q = np.array([s * s / 4, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]]) / s
    elif i == 1:
        q = np.array([m[2, 1] - m[1, 2], s * s / 4, m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]]) / s
    elif i == 2:
        q = np.array([m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], s * s / 4, m[1, 2] + m[2, 1]]) / s
    else:
        q = np.array([m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], s * s / 4]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def rpy_to_matrix_np(rpy) -> np.ndarray:
    """URDF roll/pitch/yaw -> rotation matrix, host-side float64."""
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


@dataclass(frozen=True)
class ChainSpec:
    """Dense host-side description of a serial kinematic chain (float64
    NumPy over the J actuated joints; ``tip_*`` is the fixed transform from
    the last joint's child frame to the tip frame)."""

    origin_rot: np.ndarray     # (J, 3, 3) fixed rotation preceding each joint
    origin_trans: np.ndarray   # (J, 3)
    axis: np.ndarray           # (J, 3) joint axis in the local frame
    joint_type: np.ndarray     # (J,) int, REVOLUTE or PRISMATIC
    lower: np.ndarray          # (J,) position limits
    upper: np.ndarray          # (J,)
    velocity: np.ndarray       # (J,) velocity limits
    effort: np.ndarray         # (J,) effort limits
    tip_rot: np.ndarray        # (3, 3)
    tip_trans: np.ndarray      # (3,)
    joint_names: tuple = field(default=())

    @property
    def n_joints(self) -> int:
        return self.axis.shape[0]


def build_chain(
    origins_xyz: Sequence[Sequence[float]],
    origins_rpy: Sequence[Sequence[float]],
    axes: Sequence[Sequence[float]],
    joint_types: Sequence[int],
    lower: Sequence[float],
    upper: Sequence[float],
    velocity: Optional[Sequence[float]] = None,
    effort: Optional[Sequence[float]] = None,
    pre_xyz: Sequence[float] = (0.0, 0.0, 0.0),
    pre_rpy: Sequence[float] = (0.0, 0.0, 0.0),
    tip_xyz: Sequence[float] = (0.0, 0.0, 0.0),
    tip_rpy: Sequence[float] = (0.0, 0.0, 0.0),
    joint_names: Sequence[str] = (),
) -> ChainSpec:
    """Host-side chain compiler; ``pre_*`` (a fixed transform before the
    first joint, e.g. the inverted arm mount) is folded into joint 0."""
    j = len(axes)
    rots = [rpy_to_matrix_np(origins_rpy[k]) for k in range(j)]
    trans = [np.asarray(origins_xyz[k], np.float64) for k in range(j)]
    pr, pt = rpy_to_matrix_np(pre_rpy), np.asarray(pre_xyz, np.float64)
    rots[0], trans[0] = pr @ rots[0], pt + pr @ trans[0]

    axes_np = np.asarray(axes, np.float64)
    norms = np.linalg.norm(axes_np, axis=-1, keepdims=True)
    axes_np = axes_np / np.where(norms > 0, norms, 1.0)

    big = float(np.finfo(np.float32).max)
    vel = np.asarray(velocity, np.float64) if velocity is not None else np.full((j,), big)
    eff = np.asarray(effort, np.float64) if effort is not None else np.full((j,), big)

    return ChainSpec(
        origin_rot=np.stack(rots),
        origin_trans=np.stack(trans),
        axis=axes_np,
        joint_type=np.asarray(joint_types, np.int64),
        lower=np.asarray(lower, np.float64),
        upper=np.asarray(upper, np.float64),
        velocity=vel,
        effort=eff,
        tip_rot=rpy_to_matrix_np(tip_rpy),
        tip_trans=np.asarray(tip_xyz, np.float64),
        joint_names=tuple(joint_names),
    )


def _floats(v) -> tuple:
    return tuple(float(x) for x in v)


def _const_mul(a, b: Tensor) -> Tensor:
    """Hamilton product of a constant quaternion ``a`` (floats) with a
    batched quaternion tensor ``b``."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _mul_const(a: Tensor, b) -> Tensor:
    """Hamilton product of a batched quaternion ``a`` with a constant ``b``."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _rotate_const(q: Tensor, v) -> Tensor:
    """Rotate the constant 3-vector ``v`` (floats) by quaternions ``q``:
    v + 2*(w*(u x v) + u x (u x v))."""
    w, x, y, z = q.unbind(-1)
    vx, vy, vz = v
    cx = y * vz - z * vy
    cy = z * vx - x * vz
    cz = x * vy - y * vx
    dx = y * cz - z * cy
    dy = z * cx - x * cz
    dz = x * cy - y * cx
    return torch.stack([
        vx + 2.0 * (w * cx + dx),
        vy + 2.0 * (w * cy + dy),
        vz + 2.0 * (w * cz + dz),
    ], dim=-1)


def _const_vec(v, like: Tensor) -> Tensor:
    """Broadcast the constant vector ``v`` (floats) to ``like``'s shape +
    (len(v),) without a host-to-device copy."""
    zero = torch.zeros_like(like)
    return torch.stack([zero + x for x in v], dim=-1)


def _revolute_quat(spec: ChainSpec, j: int, q_j: Tensor) -> Tensor:
    """Joint frame rotation: origin quaternion then the axis rotation."""
    half = 0.5 * q_j
    s = torch.sin(half)
    ax, ay, az = _floats(spec.axis[j])
    dq = torch.stack([torch.cos(half), s * ax, s * ay, s * az], dim=-1)
    return _const_mul(_floats(matrix_to_quat_np(spec.origin_rot[j])), dq)


def joint_rotation_terms(spec: ChainSpec, j: int):
    """Host constants (OA, OB, OC) with R_j(q) = cos q OA + sin q OB + OC:
    the fixed origin rotation of revolute joint ``j`` composed with
    Rodrigues' formula about its axis."""
    k = np.asarray(spec.axis[j], np.float64)
    kkt = np.outer(k, k)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64)
    orot = spec.origin_rot[j]
    return orot @ (np.eye(3) - kkt), orot @ kx, orot @ kkt


def joint_transform(spec: ChainSpec, j: int, q_j: Tensor) -> se3.Transform:
    """Transform across joint ``j`` (its fixed origin, then the joint's
    motion), batched over ``q_j``."""
    otrans = device_const(spec.origin_trans[j], q_j)
    if int(spec.joint_type[j]) == REVOLUTE:
        oa, ob, oc = (device_const(m, q_j) for m in joint_rotation_terms(spec, j))
        c, s = torch.cos(q_j)[..., None, None], torch.sin(q_j)[..., None, None]
        return se3.Transform(rot=c * oa + s * ob + oc, trans=otrans.expand(q_j.shape + (3,)))
    slide = device_const(spec.origin_rot[j] @ spec.axis[j], q_j)
    return se3.Transform(rot=device_const(spec.origin_rot[j], q_j).expand(q_j.shape + (3, 3)),
                         trans=otrans + slide * q_j[..., None])


def forward_kinematics(spec: ChainSpec, q: Tensor,
                       base: Optional[se3.Transform] = None) -> se3.Transform:
    """Tip pose for joint positions ``q`` [..., J] as a matrix transform with
    batch shape ``q.shape[:-1]``, composed from the optional world pose
    ``base`` of the chain root."""
    t = joint_transform(spec, 0, q[..., 0])
    if base is not None:
        t = base.compose(t)
    for j in range(1, spec.n_joints):
        t = t.compose(joint_transform(spec, j, q[..., j]))
    return t.compose(se3.Transform(device_const(spec.tip_rot, q),
                                   device_const(spec.tip_trans, q)))


def link_transforms(spec: ChainSpec, q: Tensor,
                    base: Optional[se3.Transform] = None) -> se3.Transform:
    """World pose of every joint child frame, stacked on a new axis 0:
    rotations (J,) + batch + (3, 3), translations (J,) + batch + (3,)."""
    t = joint_transform(spec, 0, q[..., 0])
    if base is not None:
        t = base.compose(t)
    ts = [t]
    for j in range(1, spec.n_joints):
        t = t.compose(joint_transform(spec, j, q[..., j]))
        ts.append(t)
    return se3.Transform(rot=torch.stack([x.rot for x in ts]),
                         trans=torch.stack([x.trans for x in ts]))


def forward_kinematics_posquat(
    spec: ChainSpec,
    q: Tensor,
    base_pos: Optional[Tensor] = None,
    base_quat: Optional[Tensor] = None,
) -> tuple:
    """Tip pose for joint positions ``q`` [..., J] as (position [..., 3],
    quaternion wxyz [..., 4]), composed from the optional base pose."""
    t_quat, t_pos = base_quat, base_pos
    for j in range(spec.n_joints):
        q_j = q[..., j]
        jt = _const_vec(_floats(spec.origin_trans[j]), q_j)
        if int(spec.joint_type[j]) == REVOLUTE:
            jq = _revolute_quat(spec, j, q_j)
        else:  # prismatic: origin rotation fixed, translation slides
            oq = _floats(matrix_to_quat_np(spec.origin_rot[j]))
            jq = _const_vec(oq, q_j)
            slide = _floats(spec.origin_rot[j] @ spec.axis[j])
            jt = jt + _const_vec(slide, q_j) * q_j[..., None]
        if t_quat is None:
            t_quat, t_pos = jq, jt
        else:
            t_pos = t_pos + rot.quat_rotate(t_quat, jt)
            t_quat = rot.quat_multiply(t_quat, jq)
    if not np.allclose(spec.tip_trans, 0.0):
        t_pos = t_pos + _rotate_const(t_quat, _floats(spec.tip_trans))
    if not np.allclose(spec.tip_rot, np.eye(3)):
        t_quat = _mul_const(t_quat, _floats(matrix_to_quat_np(spec.tip_rot)))
    return t_pos, t_quat


def joint_frames_posquat(
    spec: ChainSpec,
    q: Tensor,
    base_pos: Tensor,
    base_quat: Tensor,
) -> tuple:
    """The world-frame origin and rotation axis of every revolute joint and
    the tip pose: (origins [..., J, 3], axes [..., J, 3], tip position
    [..., 3], tip quaternion [..., 4]).  Joint j turns the chain beyond it
    about ``axes[j]`` through ``origins[j]``, so the tip moves by
    axes[j] x (tip - origins[j]) per radian: the exact geometric Jacobian."""
    t_quat, t_pos = base_quat, base_pos
    origins, axes = [], []
    for j in range(spec.n_joints):
        if int(spec.joint_type[j]) != REVOLUTE:
            raise ValueError("joint_frames_posquat takes revolute chains")
        jt = _const_vec(_floats(spec.origin_trans[j]), q[..., j])
        t_pos = t_pos + rot.quat_rotate(t_quat, jt)
        t_quat = rot.quat_multiply(t_quat, _revolute_quat(spec, j, q[..., j]))
        origins.append(t_pos)
        axes.append(_rotate_const(t_quat, _floats(spec.axis[j])))
    if not np.allclose(spec.tip_trans, 0.0):
        t_pos = t_pos + _rotate_const(t_quat, _floats(spec.tip_trans))
    if not np.allclose(spec.tip_rot, np.eye(3)):
        t_quat = _mul_const(t_quat, _floats(matrix_to_quat_np(spec.tip_rot)))
    return torch.stack(origins, dim=-2), torch.stack(axes, dim=-2), t_pos, t_quat


def link_positions_posquat(spec: ChainSpec, q: Tensor, offsets: np.ndarray) -> Tensor:
    """World-frame position of a fixed offset point (e.g. the link COM) in
    every joint child frame, from the chain root.  offsets: (J, 3) host
    constants.  Returns [..., J, 3] (revolute chains)."""
    t_quat = t_pos = None
    points = []
    for j in range(spec.n_joints):
        ot = _floats(spec.origin_trans[j])
        jq = _revolute_quat(spec, j, q[..., j])
        if t_quat is None:
            t_quat, t_pos = jq, _const_vec(ot, q[..., j])
        else:
            t_pos = t_pos + _rotate_const(t_quat, ot)
            t_quat = rot.quat_multiply(t_quat, jq)
        points.append(t_pos + _rotate_const(t_quat, _floats(offsets[j])))
    return torch.stack(points, dim=-2)
