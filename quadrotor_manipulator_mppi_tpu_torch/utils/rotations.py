"""Batched 3D rotation conversions in PyTorch.

Port of the JAX package's ``utils/rotations.py`` with the same conventions:

* every function maps over arbitrary leading batch dims (``[...]``),
* branch selection is elementwise (``torch.where``), never data-dependent
  Python control flow, so the functions run unchanged on the card,
* inverse rotations are transposes,
* quaternions are **wxyz (scalar-first)**; use :func:`quat_from_xyzw` /
  :func:`quat_to_xyzw` at ROS boundaries.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Quaternion helpers (wxyz, scalar-first)
# ---------------------------------------------------------------------------

def quat_from_xyzw(q_xyzw: Tensor) -> Tensor:
    """ROS-order (x, y, z, w) -> scalar-first (w, x, y, z)."""
    return torch.cat([q_xyzw[..., 3:4], q_xyzw[..., :3]], dim=-1)


def quat_to_xyzw(q_wxyz: Tensor) -> Tensor:
    """Scalar-first (w, x, y, z) -> ROS-order (x, y, z, w)."""
    return torch.cat([q_wxyz[..., 1:4], q_wxyz[..., 0:1]], dim=-1)


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quat_conjugate(q: Tensor) -> Tensor:
    """Conjugate == inverse for unit quaternions."""
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b, both wxyz, batched."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v ([..., 3]) by unit quaternions q ([..., 4] wxyz):
    v' = v + 2*w*(u x v) + 2*(u x (u x v))."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q: Tensor) -> Tensor:
    """Unit quaternion (wxyz) -> rotation matrix [..., 3, 3]."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: Tensor) -> Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion wxyz, branchless.

    Computes all four Shepperd candidates and selects the best-conditioned
    one by index (first maximum on ties, as the reference's argmax)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    t_w = 1.0 + m00 + m11 + m22
    t_x = 1.0 + m00 - m11 - m22
    t_y = 1.0 - m00 + m11 - m22
    t_z = 1.0 - m00 - m11 + m22

    def safe_sqrt(t):
        return torch.sqrt(t.clamp(min=_EPS))

    sw, sx, sy, sz = safe_sqrt(t_w), safe_sqrt(t_x), safe_sqrt(t_y), safe_sqrt(t_z)

    q_w = torch.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], -1) / (2.0 * sw)[..., None]
    q_x = torch.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], -1) / (2.0 * sx)[..., None]
    q_y = torch.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], -1) / (2.0 * sy)[..., None]
    q_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], -1) / (2.0 * sz)[..., None]

    best = torch.argmax(torch.stack([t_w, t_x, t_y, t_z], dim=-1), dim=-1)
    cand = torch.stack([q_w, q_x, q_y, q_z], dim=-2)  # [..., 4 candidates, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)  # canonical w >= 0
    return quat_normalize(q)


def quat_from_axis_angle(axis_angle: Tensor) -> Tensor:
    """Rotation vector [..., 3] (axis * angle) -> quaternion wxyz, with the
    series branch sin(a/2)/a ~ 1/2 - a^2/48 below 1e-6 rad."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = 0.5 * angle
    scale = torch.where(
        angle > 1e-6,
        torch.sin(half) / angle.clamp(min=_EPS),
        0.5 - angle * angle / 48.0,
    )
    return torch.cat([torch.cos(half), axis_angle * scale], dim=-1)


def quat_to_axis_angle(q: Tensor) -> Tensor:
    """Quaternion wxyz -> rotation vector [..., 3] (shortest arc)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = q[..., 0:1].clamp(-1.0, 1.0)
    v = q[..., 1:4]
    norm_v = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm_v, w)
    scale = torch.where(
        norm_v > 1e-6, angle / norm_v.clamp(min=_EPS), 2.0 / w.clamp(min=_EPS)
    )
    return v * scale


# ---------------------------------------------------------------------------
# Single-axis rotations and Euler angles
# ---------------------------------------------------------------------------

def _rot(a: Tensor, axis: str) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, i = torch.zeros_like(a), torch.ones_like(a)
    rows = {
        "X": [i, o, o, o, c, -s, o, s, c],
        "Y": [c, o, s, o, i, o, -s, o, c],
        "Z": [c, -s, o, s, c, o, o, o, i],
    }[axis]
    return torch.stack(rows, dim=-1).reshape(a.shape + (3, 3))


def euler_to_matrix(angles: Tensor, convention: str = "ZYX") -> Tensor:
    """Euler/Tait-Bryan angles [..., 3] -> rotation matrix;
    ``"ZYX"`` composes ``Rz(a0) @ Ry(a1) @ Rx(a2)``."""
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"bad euler convention: {convention}")
    r0 = _rot(angles[..., 0], convention[0])
    r1 = _rot(angles[..., 1], convention[1])
    r2 = _rot(angles[..., 2], convention[2])
    return r0 @ r1 @ r2


_AXIS_IDX = {"X": 0, "Y": 1, "Z": 2}


def matrix_to_euler(m: Tensor, convention: str = "ZYX") -> Tensor:
    """Rotation matrix -> Tait-Bryan angles (all-distinct-axes conventions):
    the central angle from ``R[i, k] = ±sin(a1)``, the outer ones from
    ``atan2`` of adjacent elements."""
    if (len(convention) != 3 or len(set(convention)) != 3
            or any(c not in "XYZ" for c in convention)):
        raise ValueError(
            f"only proper Tait-Bryan conventions supported, got {convention}"
        )
    i0, i1, i2 = (_AXIS_IDX[c] for c in convention)
    sign = 1.0 if (i1 - i0) % 3 == 1 else -1.0
    a1 = torch.asin((sign * m[..., i0, i2]).clamp(-1.0, 1.0))
    a0 = torch.atan2(-sign * m[..., i1, i2], m[..., i2, i2])
    a2 = torch.atan2(-sign * m[..., i0, i1], m[..., i0, i0])
    return torch.stack([a0, a1, a2], dim=-1)
