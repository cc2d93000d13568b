"""Lee geometric SE(3) position controller — the RotorS standard path.

Port of the JAX package's ``sim/lee_controller.py`` (the reference's
``lee_position_controller.cpp``): the desired acceleration from the
position and velocity errors over the mass, less gravity and the
feed-forward; the desired attitude from (b1(yaw), b3 = -a/|a|); the
attitude error e_R = 0.5 vee(Rd^T R - R^T Rd) and the rate error with
inertia-normalized gains; the thrust -m a . R e3.  Gains are per axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.multirotor import GRAVITY, MultirotorParams
from ..utils import rotations as rot
from ..utils import se3
from ..utils.device import device_const

Tensor = torch.Tensor


@dataclass(frozen=True)
class LeeGains:
    """Per-axis gains (position, velocity, attitude, angular rate): the
    RotorS firefly tuning rescaled to the HarrierD7's mass and inertia, the
    yaw loop placed at ~3 rad/s critically damped.  Position steps that
    command more than ~40 deg of tilt leave this plant's envelope: shape the
    reference instead (a clamped carrot and a yaw slew, as the waypoint-file
    scenario does)."""

    position: tuple = (56.3, 56.3, 56.3)
    velocity: tuple = (44.1, 44.1, 44.1)
    attitude: tuple = (135.5, 257.0, 23.0)
    angular_rate: tuple = (23.5, 44.5, 15.5)


class LeeSetpoint(NamedTuple):
    """Trajectory point: position, velocity and acceleration feed-forward,
    yaw and yaw rate (tensors; :func:`setpoint` fills the defaults)."""

    position: Tensor      # (3,)
    velocity: Tensor      # (3,)
    acceleration: Tensor  # (3,)
    yaw: Tensor           # ()
    yaw_rate: Tensor      # ()


def setpoint(position, velocity=None, acceleration=None, yaw=0.0, yaw_rate=0.0,
             dtype=torch.float32, device=None) -> LeeSetpoint:
    """A :class:`LeeSetpoint` with zero feed-forward, yaw and yaw rate
    where not given.  A tensor argument is used as it is (on its device,
    ``device`` by default), so a setpoint built inside a captured step
    makes no host copy."""
    if isinstance(position, Tensor):
        device = position.device if device is None else device
    p = torch.as_tensor(position, dtype=dtype, device=device)

    def vec(x):
        return torch.zeros(3, dtype=dtype, device=p.device) if x is None \
            else torch.as_tensor(x, dtype=dtype, device=p.device)

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=p.device) if isinstance(x, Tensor) \
            else torch.full((), float(x), dtype=dtype, device=p.device)

    return LeeSetpoint(p, vec(velocity), vec(acceleration), scalar(yaw), scalar(yaw_rate))


def lee_control(gains: LeeGains, vehicle: MultirotorParams, sp: LeeSetpoint, pos: Tensor,
                vel_world: Tensor, quat: Tensor, omega_body: Tensor,
                extra_mass: float = 0.0) -> Tensor:
    """U = [thrust, tau_x, tau_y, tau_z] (body frame) for one vehicle.
    The attitude gains are normalized by the inertia, and the gyroscopic
    ``omega x I omega`` term of the reference's last line is kept."""
    m = vehicle.mass + extra_mass
    inertia = device_const(vehicle.inertia, pos)
    kp, kv = device_const(gains.position, pos), device_const(gains.velocity, pos)
    kr = device_const(gains.attitude, pos) / inertia
    kw = device_const(gains.angular_rate, pos) / inertia

    r = rot.quat_to_matrix(quat)
    # Desired acceleration (error = state - command; it points down the error).
    accel = ((pos - sp.position) * kp + (vel_world - sp.velocity) * kv) / m \
        - device_const([0.0, 0.0, GRAVITY], pos) - sp.acceleration

    # Desired attitude.
    b1_des = torch.stack([torch.cos(sp.yaw), torch.sin(sp.yaw), torch.zeros_like(sp.yaw)])
    b3_des = -accel / torch.linalg.norm(accel).clamp(min=1e-6)
    b2_des = torch.linalg.cross(b3_des, b1_des, dim=-1)
    b2_des = b2_des / torch.linalg.norm(b2_des).clamp(min=1e-6)
    r_des = torch.stack([torch.linalg.cross(b2_des, b3_des, dim=-1), b2_des, b3_des], dim=-1)

    # Attitude and rate errors.
    angle_err = se3.unskew(0.5 * (r_des.T @ r - r.T @ r_des))
    zero = torch.zeros_like(sp.yaw_rate)
    rate_des = torch.stack([zero, zero, sp.yaw_rate])
    rate_err = omega_body - r_des.T @ r @ rate_des

    ang_acc = -angle_err * kr - rate_err * kw
    torque = inertia * ang_acc + torch.linalg.cross(omega_body, inertia * omega_body, dim=-1)
    thrust = -m * torch.dot(accel, r[:, 2])
    return torch.cat([thrust[None], torque])
