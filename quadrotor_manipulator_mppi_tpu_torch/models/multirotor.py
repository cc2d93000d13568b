"""HarrierD7 octorotor: vehicle constants, the full plant and the reduced
rollout state.

Port of the JAX package's ``models/multirotor.py``: the vehicle constants
(the same fields, so its configuration tree carries across unchanged) with
the allocation matrix and its pseudo-inverse; the quaternion plant state and
its semi-implicit Euler step with the asymmetric first-order rotor lag,
rotor drag and rolling moment, and the inelastic ground clamp of free
flight; and :class:`Multirotor12State`, the solver's reduced state.
Penalty ground contact, wind and payload inertia come with the payload and
contact slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import rotations as rot
from ..utils.device import device_const

Tensor = torch.Tensor

GRAVITY = 9.81

_LATER = "the payload and ground-contact slice of the port"


@dataclass(frozen=True)
class MultirotorParams:
    mass: float = 14.7
    inertia: tuple = (1.57, 3.93, 2.59)
    n_rotors: int = 8
    motor_constant: float = 4.63e-4      # k_f [N s^2]
    moment_constant: float = 0.0173      # k_m [m]
    xlen: float = 0.534
    ylen: float = 0.574
    max_rotor_speed: float = 650.0
    time_constant_up: float = 0.0125
    time_constant_down: float = 0.025
    rotor_drag_coefficient: float = 8.06428e-5
    rolling_moment_coefficient: float = 1e-6
    ground_z: float = 0.0
    # Allocation sign rows (roll, pitch, yaw) per rotor.
    roll_signs: tuple = (-1, 1, 1, -1, -1, 1, 1, -1)
    pitch_signs: tuple = (-1, -1, 1, 1, -1, -1, 1, 1)
    yaw_signs: tuple = (1, -1, 1, -1, -1, 1, -1, 1)
    # Alternative per-rotor geometry (angle, arm, k_f, k_m, direction).
    rotor_config: tuple = ()

    def allocation_matrix(self) -> np.ndarray:
        """(4, R) map from rotor speed^2 to [tau_roll, tau_pitch, tau_yaw, T]."""
        if self.rotor_config:
            cols = [[np.sin(angle) * arm * kf, -np.cos(angle) * arm * kf,
                     -direction * kf * km, kf]
                    for angle, arm, kf, km, direction in self.rotor_config]
            return np.asarray(cols, np.float64).T
        f, m = self.motor_constant, self.moment_constant
        return np.stack([
            np.asarray(self.roll_signs, np.float64) * self.ylen * f,
            np.asarray(self.pitch_signs, np.float64) * self.xlen * f,
            np.asarray(self.yaw_signs, np.float64) * f * m,
            np.full(self.n_rotors, f),
        ])

    def allocation_pinv(self) -> np.ndarray:
        """(R, 4) right pseudo-inverse A^T (A A^T)^-1."""
        a = self.allocation_matrix()
        return a.T @ np.linalg.inv(a @ a.T)

    def hover_rotor_speed(self, extra_mass: float = 0.0) -> float:
        thrust = (self.mass + extra_mass) * GRAVITY
        kf_total = (sum(r[2] for r in self.rotor_config) if self.rotor_config
                    else self.n_rotors * self.motor_constant)
        return float(np.sqrt(thrust / kf_total))


class MultirotorState(NamedTuple):
    pos: Tensor          # (…, 3) world position
    quat: Tensor         # (…, 4) wxyz body->world
    vel: Tensor          # (…, 3) world linear velocity
    omega: Tensor        # (…, 3) body angular velocity
    rotor_speed: Tensor  # (…, R) rotor speeds (first-order lagged)


def init_state(params: MultirotorParams, pos=(0.0, 0.0, 0.0), batch_shape=(),
               dtype=torch.float32, device=None) -> MultirotorState:
    batch_shape = tuple(batch_shape)

    def full(values):
        t = torch.tensor(values, dtype=dtype, device=device)
        return t.expand(batch_shape + t.shape).clone()

    return MultirotorState(
        pos=full(list(pos)), quat=full([1.0, 0.0, 0.0, 0.0]), vel=full([0.0] * 3),
        omega=full([0.0] * 3), rotor_speed=full([0.0] * params.n_rotors),
    )


def wrench_from_rotors(params: MultirotorParams, rotor_speed: Tensor,
                       vel_body_perp: Tensor) -> tuple:
    """Body-frame (force, torque) from rotor speeds; ``vel_body_perp`` is
    the body-frame airspeed perpendicular to the rotor axis (rotor drag and
    rolling moment)."""
    alloc = device_const(params.allocation_matrix(), rotor_speed)
    tau_thrust = torch.einsum("ir,...r->...i", alloc, rotor_speed * rotor_speed)
    abs_w_sum = rotor_speed.abs().sum(-1, keepdim=True)
    drag = -params.rotor_drag_coefficient * abs_w_sum * vel_body_perp
    rolling = -params.rolling_moment_coefficient * abs_w_sum * vel_body_perp
    force = drag + torch.cat([torch.zeros_like(tau_thrust[..., :2]), tau_thrust[..., 3:4]], -1)
    return force, tau_thrust[..., :3] + rolling


def rotor_lag(params: MultirotorParams, rotor_speed: Tensor, rotor_cmd: Tensor,
              dt: float) -> Tensor:
    """Asymmetric first-order rotor-speed filter: the time constant is
    picked per rotor by whether the command is above the speed.  The two
    decay factors exp(-dt/tau) are host constants, as in the plant-tick
    kernel."""
    cmd = rotor_cmd.clamp(0.0, params.max_rotor_speed)
    alpha = torch.where(cmd > rotor_speed, float(np.exp(-dt / params.time_constant_up)),
                        float(np.exp(-dt / params.time_constant_down))).to(rotor_speed.dtype)
    return alpha * rotor_speed + (1.0 - alpha) * cmd


def step(params: MultirotorParams, state: MultirotorState, rotor_cmd: Tensor, dt: float,
         extra_mass: float = 0.0, external_wrench_body: Optional[tuple] = None,
         wind_world: Optional[Tensor] = None, contact=None, gear_ext=1.0,
         extra_inertia: Optional[Tensor] = None) -> MultirotorState:
    """One semi-implicit Euler step (batched over leading dims) of the free
    flight plant, with the inelastic ground clamp."""
    if wind_world is not None or contact is not None or extra_inertia is not None:
        raise NotImplementedError(f"wind, ground contact and payload inertia wait for {_LATER}")
    m = params.mass + extra_mass
    inertia = device_const(params.inertia, state.pos)
    rotor_speed = rotor_lag(params, state.rotor_speed, rotor_cmd, dt)

    r = rot.quat_to_matrix(state.quat)  # body -> world
    v_body = (r.transpose(-1, -2) @ state.vel.unsqueeze(-1)).squeeze(-1)
    v_perp = torch.cat([v_body[..., :2], torch.zeros_like(v_body[..., 2:])], -1)
    force_b, torque_b = wrench_from_rotors(params, rotor_speed, v_perp)
    if external_wrench_body is not None:
        force_b = force_b + external_wrench_body[0]
        torque_b = torque_b + external_wrench_body[1]

    acc = (r @ force_b.unsqueeze(-1)).squeeze(-1) / m - device_const([0.0, 0.0, GRAVITY], state.pos)
    omega_dot = (torque_b - torch.linalg.cross(state.omega, inertia * state.omega, dim=-1)) / inertia
    vel = state.vel + acc * dt
    pos = state.pos + vel * dt
    omega = state.omega + omega_dot * dt

    # Inelastic ground contact: clamp to the plane, kill downward velocity
    # and spin.
    on_ground = pos[..., 2:3] <= params.ground_z
    pos = torch.cat([pos[..., :2], pos[..., 2:].clamp(min=params.ground_z)], -1)
    grounded_vel = torch.cat([torch.zeros_like(vel[..., :2]), vel[..., 2:].clamp(min=0.0)], -1)
    vel = torch.where(on_ground, grounded_vel, vel)
    omega = torch.where(on_ground, 0.0, omega)

    dq = rot.quat_from_axis_angle(omega * dt)
    quat = rot.quat_normalize(rot.quat_multiply(state.quat, dq))
    return MultirotorState(pos=pos, quat=quat, vel=vel, omega=omega, rotor_speed=rotor_speed)


class Multirotor12State(NamedTuple):
    """Reduced state for sampled rollouts: (roll, pitch, yaw) attitude."""

    pos: torch.Tensor    # (…, 3)
    rpy: torch.Tensor    # (…, 3)
    vel: torch.Tensor    # (…, 3) world
    omega: torch.Tensor  # (…, 3) body
