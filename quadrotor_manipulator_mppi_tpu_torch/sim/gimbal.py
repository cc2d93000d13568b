"""3-axis camera gimbal: world-frame P servo of the depth camera.

Port of the JAX package's ``sim/gimbal.py`` (the reference's gimbal
controller plugin): three revolute joints built yaw-roll-pitch, a P-only
servo per axis with force clamps, and commands read as world-frame camera
angles, so the camera holds its pointing through the base's motion.  The
joint physics (inertia and viscous damping) is integrated semi-implicitly;
the commanded correction is clamped so the joint target stays inside its
limits, and the joint state saturates at the stops.

Every function is plain tensor arithmetic on the device of its inputs, with
any leading batch dims, and makes no host copy after its first call (the
constants come from ``utils/device.device_const``), so it runs inside a
captured control step.  :func:`camera_rotation` gives the optical -> world
rotation that ``sim/depth_camera.depth_render`` takes; :func:`point_at`
the world command that aims the optical axis at a target.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils import rotations as rot
from ..utils.device import device_const

Tensor = torch.Tensor

_TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class GimbalParams:
    """Per-axis P gains and force clamps of the reference plugin; the joint
    inertia and damping model the small camera-arm links."""

    kp_pitch: float = 5.0
    kp_roll: float = 5.0
    kp_yaw: float = 1.0
    force_limit_rp: float = 0.3    # [N*m] pitch/roll clamp
    force_limit_yaw: float = 1.0   # [N*m] yaw clamp
    inertia: float = 0.004         # [kg*m^2] per joint
    damping: float = 0.12          # [N*m*s/rad]
    # Joint limits: pitch sweeps horizon -> straight down and beyond; roll
    # trims; yaw is continuous.
    pitch_limits: Tuple[float, float] = (-0.5, 2.2)
    roll_limits: Tuple[float, float] = (-0.785, 0.785)


class GimbalState(NamedTuple):
    angles: Tensor   # (..., 3) joint angles [pitch, roll, yaw]
    rates: Tensor    # (..., 3)


def init_gimbal(dtype=torch.float32, device=None) -> GimbalState:
    return GimbalState(angles=torch.zeros(3, dtype=dtype, device=device),
                       rates=torch.zeros(3, dtype=dtype, device=device))


def quat_to_zxy(q: Tensor) -> Tensor:
    """World orientation -> (pitch, roll, yaw) in the plugin's ZXY-variable
    decomposition: R = Rz(yaw) Rx(roll) Ry(pitch)."""
    w, x, y, z = q.unbind(-1)
    pitch = torch.atan2(-2.0 * (x * z - w * y), w * w - x * x - y * y + z * z)
    roll = torch.asin(torch.clamp(2.0 * (y * z + w * x), -1.0, 1.0))
    yaw = torch.atan2(-2.0 * (x * y - w * z), w * w - x * x + y * y - z * z)
    return torch.stack([pitch, roll, yaw], dim=-1)


def _axis_quat(h: Tensor, axis: int) -> Tensor:
    """The quaternion of a rotation by 2h about one coordinate axis, built
    by stacking (no write into an input)."""
    zero = torch.zeros_like(h)
    s = torch.sin(h)
    return torch.stack([torch.cos(h)] + [s if a == axis else zero for a in range(3)], dim=-1)


def _joint_quat(angles: Tensor) -> Tensor:
    """Joint stack orientation (gimbal base -> camera): yaw about z, then
    roll about x, then pitch about y."""
    half = 0.5 * angles
    qz = _axis_quat(half[..., 2], 2)
    qx = _axis_quat(half[..., 1], 0)
    qy = _axis_quat(half[..., 0], 1)
    return rot.quat_multiply(rot.quat_multiply(qz, qx), qy)


def camera_quat(state: GimbalState, base_quat: Tensor) -> Tensor:
    """World orientation of the camera head: the base attitude composed
    with the joint stack."""
    return rot.quat_multiply(base_quat, _joint_quat(state.angles))


# Optical (z forward, x right, y down: the depth camera's convention)
# expressed in the camera-head frame (x forward, y left, z up).
_R_HEAD_OPTICAL = ((0.0, 0.0, 1.0),
                   (-1.0, 0.0, 0.0),
                   (0.0, -1.0, 0.0))


def camera_rotation(state: GimbalState, base_quat: Tensor) -> Tensor:
    """Optical -> world rotation (..., 3, 3) for ``depth_render``."""
    r_head = rot.quat_to_matrix(camera_quat(state, base_quat))
    return r_head @ device_const(_R_HEAD_OPTICAL, r_head)


def point_at(cam_pos: Tensor, target: Tensor) -> Tensor:
    """World (pitch, roll, yaw) command aiming the optical axis at
    ``target``, roll level.  Pitch 0 is the horizon, +pi/2 straight down."""
    d = target - cam_pos
    yaw = torch.atan2(d[..., 1], d[..., 0])
    pitch = torch.atan2(-d[..., 2], torch.hypot(d[..., 0], d[..., 1]))
    return torch.stack([pitch, torch.zeros_like(yaw), yaw], dim=-1)


def _shortest(a: Tensor) -> Tensor:
    """Wrap to (-pi, pi]; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    return a - _TWO_PI * torch.round(a / _TWO_PI)


def gimbal_step(params: GimbalParams, state: GimbalState, cmd_pry_world: Tensor,
                base_quat: Tensor, dt: float) -> GimbalState:
    """One control tick: world-frame P servo -> joint forces -> joint
    dynamics.  ``cmd_pry_world`` (..., 3) is the world [pitch, roll, yaw]
    command, ``base_quat`` (..., 4) the base body -> world (wxyz)."""
    like = state.angles
    cur = quat_to_zxy(camera_quat(state, base_quat))       # (pitch, roll, yaw)
    err = _shortest(cmd_pry_world - cur)

    # Never demand a correction that would push a joint past its stop; yaw
    # has none (its bounds are +-inf).
    lo = device_const([params.pitch_limits[0], params.roll_limits[0], -np.inf], like)
    hi = device_const([params.pitch_limits[1], params.roll_limits[1], np.inf], like)
    err = torch.clamp(err, lo - state.angles, hi - state.angles)

    kp = device_const([params.kp_pitch, params.kp_roll, params.kp_yaw], like)
    fmax = device_const([params.force_limit_rp, params.force_limit_rp, params.force_limit_yaw],
                        like)
    force = torch.clamp(kp * err, -fmax, fmax)

    acc = (force - params.damping * state.rates) / params.inertia
    rates = state.rates + acc * dt
    raw = state.angles + rates * dt
    angles = torch.clamp(raw, lo, hi)
    rates = torch.where((raw < lo) | (raw > hi), torch.zeros_like(rates), rates)
    return GimbalState(angles=angles, rates=rates)
