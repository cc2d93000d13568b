"""HarrierD7 octorotor: vehicle constants, the full plant and the reduced
rollout state.

Port of the JAX package's ``models/multirotor.py``: the vehicle constants
(the same fields, so its configuration tree carries across unchanged) with
the allocation matrix and its pseudo-inverse; the quaternion plant state and
its semi-implicit Euler step with the asymmetric first-order rotor lag,
rotor drag and rolling moment, and the inelastic ground clamp of free
flight, or the penalty ground contact at the landing-gear feet, the wind's
airspeed and a grasped payload's inertia; and :class:`Multirotor12State`,
the solver's reduced euler-angle state, with its explicit-Euler step
:func:`step12` (the sequential wrench rollout).
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


@dataclass(frozen=True)
class GroundContactParams:
    """Penalty ground contact at the landing-gear feet: per foot a
    spring-damper normal force and regularized Coulomb friction, applied at
    the foot's body-frame offset (so touchdown also makes righting
    torques).  Four feet under the arms by default; the stiffness gives
    ~2.5 mm of static penetration for the 20 kg vehicle."""

    stiffness: float = 2.0e4        # [N/m] per foot
    damping: float = 400.0          # [N s/m] per foot
    friction_mu: float = 0.8
    friction_vel_eps: float = 0.05  # [m/s] Coulomb regularization
    gear_height: float = 0.35       # [m] foot below base, gear extended
    belly_height: float = 0.10      # [m] contact offset, gear retracted
    foot_xy: tuple = ((0.4, 0.43), (0.4, -0.43), (-0.4, 0.43), (-0.4, -0.43))


def ground_contact_wrench(contact: GroundContactParams, pos: Tensor, r: Tensor, vel: Tensor,
                          omega: Tensor, gear_ext, ground_z: float) -> tuple:
    """World-frame contact force and BODY-frame torque from all feet.
    ``r`` is the body->world rotation; ``gear_ext`` in [0, 1] (a float or a
    tensor) interpolates the foot height between the belly (retracted) and
    the gear (extended)."""
    height = contact.belly_height + (contact.gear_height - contact.belly_height) * gear_ext
    xy = device_const(contact.foot_xy, pos)                             # (F, 2)
    if isinstance(height, Tensor):
        down = -height.to(pos.dtype) * torch.ones_like(xy[:, :1])
    else:  # a host constant: no copy to the card per call
        down = device_const([[-height]] * len(contact.foot_xy), pos)
    feet_b = torch.cat([xy, down], dim=-1)                              # (F, 3)
    arm_w = torch.einsum("...ij,fj->...fi", r, feet_b)                  # (..., F, 3)
    feet_w = pos.unsqueeze(-2) + arm_w
    omega_w = rot.matvec(r, omega)
    # Foot velocity: v + omega x r (omega body -> world).
    feet_v = vel.unsqueeze(-2) + torch.linalg.cross(
        omega_w.unsqueeze(-2).expand_as(feet_w), feet_w - pos.unsqueeze(-2), dim=-1)
    pen = (ground_z - feet_w[..., 2]).clamp(min=0.0)                   # (..., F)
    fn = (contact.stiffness * pen - contact.damping * feet_v[..., 2]).clamp(min=0.0) \
        * (pen > 0.0)
    vt = feet_v[..., :2]
    ft = -contact.friction_mu * fn.unsqueeze(-1) * vt / (
        torch.linalg.norm(vt, dim=-1, keepdim=True) + contact.friction_vel_eps)
    f_w = torch.cat([ft, fn.unsqueeze(-1)], dim=-1)                    # (..., F, 3)
    force_w = f_w.sum(-2)
    # Torque about the COM, expressed in the body frame.
    tau_w = torch.linalg.cross(feet_w - pos.unsqueeze(-2), f_w, dim=-1).sum(-2)
    return force_w, rot.matvec(r.transpose(-1, -2), tau_w)


def payload_point_mass_effects(mass: float, r_body: Tensor) -> tuple:
    """A rigidly grasped point payload at body-frame offset ``r_body``:
    (``m * r_body``, the moment arm premultiplied for the caller's gravity
    torque, and the parallel-axis diagonal inertia increment
    ``m (|r|^2 - r_i^2)``)."""
    r2 = torch.sum(r_body * r_body, dim=-1, keepdim=True)
    return mass * r_body, mass * (r2 - r_body * r_body)


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
         extra_mass=0.0, external_wrench_body: Optional[tuple] = None,
         wind_world: Optional[Tensor] = None, contact: Optional[GroundContactParams] = None,
         gear_ext=1.0, extra_inertia: Optional[Tensor] = None) -> MultirotorState:
    """One semi-implicit Euler step (batched over leading dims).

    ``extra_mass`` is a rigidly attached lump (a float or a tensor);
    ``external_wrench_body`` couples in a body-frame (force, torque);
    ``wind_world`` feeds the rotor-drag airspeed; ``extra_inertia`` is a
    diagonal body-inertia increment (:func:`payload_point_mass_effects`).
    With ``contact`` set, the per-foot penalty forces of
    :func:`ground_contact_wrench` (gear extension ``gear_ext``); without
    it, the inelastic clamp to the ground plane."""
    m = params.mass + extra_mass
    inertia = device_const(params.inertia, state.pos)
    if extra_inertia is not None:
        inertia = inertia + extra_inertia
    rotor_speed = rotor_lag(params, state.rotor_speed, rotor_cmd, dt)

    r = rot.quat_to_matrix(state.quat)  # body -> world
    airspeed = state.vel if wind_world is None else state.vel - wind_world
    v_body = rot.matvec(r.transpose(-1, -2), airspeed)
    v_perp = torch.cat([v_body[..., :2], torch.zeros_like(v_body[..., 2:])], -1)
    force_b, torque_b = wrench_from_rotors(params, rotor_speed, v_perp)
    if external_wrench_body is not None:
        force_b = force_b + external_wrench_body[0]
        torque_b = torque_b + external_wrench_body[1]

    acc = rot.matvec(r, force_b) / m - device_const([0.0, 0.0, GRAVITY], state.pos)
    if contact is not None:
        cf_w, ct_b = ground_contact_wrench(contact, state.pos, r, state.vel, state.omega,
                                           gear_ext, params.ground_z)
        acc = acc + cf_w / m
        torque_b = torque_b + ct_b
    omega_dot = (torque_b - torch.linalg.cross(state.omega, inertia * state.omega, dim=-1)) / inertia
    vel = state.vel + acc * dt
    pos = state.pos + vel * dt
    omega = state.omega + omega_dot * dt

    if contact is None:
        # Inelastic ground contact: clamp to the plane, kill downward
        # velocity and spin.
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


def euler_rate_matrix(rpy: Tensor) -> Tensor:
    """Body rates -> euler-angle rates: eta_dot = J(eta) omega."""
    phi, theta = rpy[..., 0], rpy[..., 1]
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    ttheta, ctheta = torch.tan(theta), torch.cos(theta)
    o, i = torch.zeros_like(phi), torch.ones_like(phi)
    m = torch.stack([i, sphi * ttheta, cphi * ttheta,
                     o, cphi, -sphi,
                     o, sphi / ctheta, cphi / ctheta], dim=-1)
    return m.reshape(rpy.shape[:-1] + (3, 3))


def step12(params: MultirotorParams, state: Multirotor12State, u: Tensor, dt: float,
           extra_mass: float = 0.0, drag_kd: float = 0.0,
           rate_damping: float = 0.0) -> Multirotor12State:
    """Explicit-Euler reduced step with the wrench input u = [T, tau_x,
    tau_y, tau_z]: omega <- (1 - dt kd) omega + dt I^-1 tau; eta <- eta + dt
    J(eta) omega, the angles wrapped to [-pi, pi]; v <- v + dt (R f / m - g -
    k_d v); p <- p + dt v.  ``rate_damping`` is the wrench mode's body-rate
    feedback, so the rollout models the damped loop."""
    m = params.mass + extra_mass
    inertia = device_const(params.inertia, state.pos)
    omega = (1.0 - dt * rate_damping) * state.omega + dt * (u[..., 1:4] / inertia)
    rpy = state.rpy + dt * rot.matvec(euler_rate_matrix(state.rpy), omega)
    rpy = torch.atan2(torch.sin(rpy), torch.cos(rpy))
    r = rot.euler_to_matrix(torch.stack([rpy[..., 2], rpy[..., 1], rpy[..., 0]], dim=-1), "ZYX")
    thrust_b = torch.cat([torch.zeros_like(u[..., :2]), u[..., 0:1]], dim=-1)
    acc = rot.matvec(r, thrust_b) / m - device_const([0.0, 0.0, GRAVITY], state.pos) \
        - drag_kd * state.vel
    vel = state.vel + dt * acc
    pos = state.pos + dt * vel
    return Multirotor12State(pos=pos, rpy=rpy, vel=vel, omega=omega)
