"""Inner-loop flight control of the octorotor plant.

Port of the JAX package's ``sim/flight_control.py`` (the parts the
whole-body and drone loops run): the PID position + PD attitude law
(:func:`pid_step`), the adaptive backstepping law
(:func:`backstepping_step`, with its optional safeguards), the
stateless attitude-command law (:func:`roll_pitch_yawrate_thrust_step`),
the pseudo-inverse rotor allocation (:func:`allocate`), the gain presets and
:func:`hover_setpoint`.  Functions of tensors
with leading batch dims; the controller state is an explicit NamedTuple.
The reference's quirks are kept as they are written, e.g. the pitch
channel's ``-kp_pitch * (z4 - kd_pitch * z3)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.multirotor import GRAVITY, MultirotorParams
from ..utils.device import device_const

Tensor = torch.Tensor


@dataclass(frozen=True)
class FlightGains:
    """Defaults = the reference's config/pid_gains.yaml."""

    kp_x: float = 3.0
    kp_y: float = 3.0
    kp_z: float = 1.4
    kd_x: float = 0.7
    kd_y: float = 0.7
    kd_z: float = 3.0
    ki_x: float = 0.2
    ki_y: float = 0.2
    ki_z: float = 0.3
    kp_roll: float = 10.0
    kp_pitch: float = 10.0
    kp_yaw: float = 1.0
    kd_roll: float = 26.0
    kd_pitch: float = 26.0
    kd_yaw: float = 2.0


# The reference's attitude gains (Kp=10, Kd=26) put the attitude loop's
# slow pole below the position loop's bandwidth, so on an ideal rigid body
# the cascade is unstable; this set speeds the attitude loop up and adds
# mild lateral and vertical damping, for the in-framework plant.
SIM_TUNED_GAINS = FlightGains(
    kp_roll=100.0, kp_pitch=100.0, kd_roll=25.0, kd_pitch=25.0,
    kd_x=1.5, kd_y=1.5, kp_z=6.0, kd_z=5.0, ki_z=1.0,
)

# Aggressive-trajectory preset: a mild lateral retune, used with the
# backstepping safeguards of :func:`aggressive_safeguards` (and acc_ff).
AGGRESSIVE_GAINS = FlightGains(kp_x=3.5, kp_y=3.5, kd_x=1.0, kd_y=1.0)


def aggressive_safeguards(vehicle: MultirotorParams) -> dict:
    """The backstepping safeguard kwargs validated with AGGRESSIVE_GAINS."""
    return dict(
        tilt_clip=0.45,
        m_hat_range=(0.5 * vehicle.mass, 2.0 * vehicle.mass),
        n_hat_clip=20.0,
        int_clip=1.0,
    )


class FlightCtrlState(NamedTuple):
    """Cross-tick controller state."""

    int_err: Tensor   # (3,) trapezoidal position-error integrals
    prev_err: Tensor  # (3,) previous position errors
    m_hat: Tensor     # (3,) adaptive mass estimates
    n_hat: Tensor     # (2,) adaptive nx, ny attitude terms


def init_ctrl_state(mass_guess: float, dtype=torch.float32, device=None) -> FlightCtrlState:
    """m_hat starts at the known mass and adapts from there."""
    return FlightCtrlState(
        int_err=torch.zeros(3, dtype=dtype, device=device),
        prev_err=torch.zeros(3, dtype=dtype, device=device),
        m_hat=torch.full((3,), float(mass_guess), dtype=dtype, device=device),
        n_hat=torch.zeros(2, dtype=dtype, device=device),
    )


class FlightSetpoint(NamedTuple):
    pos: Tensor       # (3,) desired x, y, z
    vel: Tensor       # (3,) desired velocity feed-forward
    yaw: Tensor       # () desired yaw
    yaw_rate: Tensor  # () desired yaw rate


def hover_setpoint(pos, dtype=torch.float32, device=None) -> FlightSetpoint:
    """Hold ``pos`` with zero velocity, yaw and yaw rate.  On ``device``
    (default: ``pos``'s device for a tensor, else the CPU); a device tensor
    ``pos`` is used as it is, so no host copy is made."""
    p = torch.as_tensor(pos, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=p.device)
    return FlightSetpoint(pos=p, vel=torch.zeros(3, dtype=dtype, device=p.device), yaw=zero,
                          yaw_rate=zero)


def _desired_tilt(ux: Tensor, uy: Tensor, yaw_des: Tensor) -> Tuple[Tensor, Tensor]:
    """(ux, uy) -> (roll_des, pitch_des)."""
    alpha, beta = torch.cos(yaw_des), torch.sin(yaw_des)
    v1 = alpha * ux + beta * uy
    v2 = beta * ux - alpha * uy
    sphi = v2.clamp(-1.0, 1.0)
    cphi = torch.sqrt(1.0 - sphi * sphi)
    roll_des = torch.atan2(sphi, cphi)
    v1 = v1 / torch.cos(roll_des)
    stheta = v1.clamp(-1.0, 1.0)
    ctheta = torch.sqrt(1.0 - stheta * stheta)
    return roll_des, torch.atan2(stheta, ctheta)


def _trapezoid(err: Tensor, prev_err: Tensor, integ: Tensor, dt: float) -> Tensor:
    """The reference's ``integral()`` accumulator: 0.5*(e + e_prev)*dt."""
    return integ + 0.5 * (err + prev_err) * dt


def pid_step(
    gains: FlightGains,
    vehicle: MultirotorParams,
    ctrl: FlightCtrlState,
    sp: FlightSetpoint,
    pos: Tensor,
    vel_world: Tensor,
    rpy: Tensor,
    omega_body: Tensor,
    dt: float,
    mass: Optional[float] = None,
    tau_g: Optional[Tensor] = None,
    yaw_mom: Optional[Tensor] = None,
) -> Tuple[Tensor, FlightCtrlState]:
    """PID position + PD attitude law -> (U [T, tau_x, tau_y, tau_z], new
    controller state), with a fixed known mass; ``tau_g`` is the optional
    arm gravity-torque feed-forward, ``yaw_mom`` the arm yaw reaction."""
    m = float(vehicle.mass if mass is None else mass)
    ixx, iyy, izz = vehicle.inertia
    xlen, ylen = vehicle.xlen, vehicle.ylen

    err = sp.pos - pos
    integ = _trapezoid(err, ctrl.prev_err, ctrl.int_err, dt)

    phi, theta, psi = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    p, q, r = omega_body[..., 0], omega_body[..., 1], omega_body[..., 2]

    u1 = (m * (GRAVITY + gains.kp_z * err[..., 2] - gains.kd_z * vel_world[..., 2]
               + gains.ki_z * integ[..., 2])
          / (torch.cos(phi) * torch.cos(theta)))
    ux = m / u1 * (gains.kp_x * err[..., 0] - gains.kd_x * vel_world[..., 0]
                   + gains.ki_x * integ[..., 0])
    uy = m / u1 * (gains.kp_y * err[..., 1] - gains.kd_y * vel_world[..., 1]
                   + gains.ki_y * integ[..., 1])
    roll_des, pitch_des = _desired_tilt(ux, uy, sp.yaw)

    tau_g = torch.zeros_like(pos) if tau_g is None else tau_g
    z_mom = torch.zeros_like(pos[..., 0]) if yaw_mom is None else yaw_mom

    u2 = (ixx / xlen) * (gains.kp_roll * (roll_des - phi) + gains.kd_roll * (0.0 - p)) \
        + (1.0 / xlen) * ((izz - iyy) * q * r) - tau_g[..., 0]
    u3 = (iyy / ylen) * (gains.kp_pitch * (pitch_des - theta) + gains.kd_pitch * (0.0 - q)) \
        + (1.0 / ylen) * ((ixx - izz) * p * r) - tau_g[..., 1]
    u4 = izz * (gains.kp_yaw * (sp.yaw - psi) - gains.kd_yaw * r) \
        + (iyy - ixx) * p * q - tau_g[..., 2] + z_mom

    new_ctrl = FlightCtrlState(int_err=integ, prev_err=err, m_hat=ctrl.m_hat, n_hat=ctrl.n_hat)
    return torch.stack([u1, u2, u3, u4], dim=-1), new_ctrl


def backstepping_step(
    gains: FlightGains,
    vehicle: MultirotorParams,
    ctrl: FlightCtrlState,
    sp: FlightSetpoint,
    pos: Tensor,
    vel_world: Tensor,
    rpy: Tensor,
    omega_body: Tensor,
    dt: float,
    tau_g: Optional[Tensor] = None,
    yaw_mom: Optional[Tensor] = None,
    tilt_clip: Optional[float] = None,
    m_hat_range: Optional[Tuple[float, float]] = None,
    n_hat_clip: Optional[float] = None,
    int_clip: Optional[float] = None,
    acc_ff: Optional[Tensor] = None,
) -> Tuple[Tensor, FlightCtrlState]:
    """Adaptive backstepping flight law -> (U [T, tau_x, tau_y, tau_z], new
    controller state).  Adaptive mass estimates per axis, attitude
    backstepping with adaptive nx/ny terms, gyroscopic cross terms and the
    arm gravity-torque feed-forward ``tau_g``.  The safeguards
    (``tilt_clip``, ``m_hat_range``, ``n_hat_clip``, ``int_clip``) and
    ``acc_ff`` are off by default, as in the reference."""
    ixx, iyy, izz = vehicle.inertia
    xlen, ylen = vehicle.xlen, vehicle.ylen
    tau_g = torch.zeros_like(pos) if tau_g is None else tau_g
    z_mom = torch.zeros_like(pos[..., 0]) if yaw_mom is None else yaw_mom

    phi, theta, psi = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    p, q, r = omega_body[..., 0], omega_body[..., 1], omega_body[..., 2]

    err = sp.pos - pos
    integ = _trapezoid(err, ctrl.prev_err, ctrl.int_err, dt)
    if int_clip is not None:
        integ = integ.clamp(-int_clip, int_clip)

    # altitude with adaptive mass
    e5, p5 = err[..., 2], integ[..., 2]
    e6 = gains.kp_z * e5 + sp.vel[..., 2] + gains.ki_z * p5 - vel_world[..., 2]
    az = (GRAVITY + gains.ki_z * e5
          + gains.kp_z * (-gains.kp_z * e5 - gains.ki_z * p5 + e6)
          + e5 + gains.kd_z * e6)
    if acc_ff is not None:
        az = az + acc_ff[..., 2]
    mz_hat = ctrl.m_hat[..., 2] + 3.0 * e6 * az * dt
    if m_hat_range is not None:
        mz_hat = mz_hat.clamp(m_hat_range[0], m_hat_range[1])
    u1 = (mz_hat / (torch.cos(phi) * torch.cos(theta))) * az

    # x/y with adaptive mass
    def lateral(e, pint, vd, v, kp, ki, kd, m_prev, aff):
        e2 = vd + kp * e + ki * pint - v
        a = ki * e - kp * kp * e - ki * kp * pint + kp * e2 + e + kd * e2 + aff
        m_new = m_prev + 2.0 * e2 * a * dt
        if m_hat_range is not None:
            m_new = m_new.clamp(m_hat_range[0], m_hat_range[1])
        return (m_new / u1) * a, m_new

    aff = torch.zeros_like(pos) if acc_ff is None else acc_ff
    ux, mx_hat = lateral(err[..., 0], integ[..., 0], sp.vel[..., 0], vel_world[..., 0],
                         gains.kp_x, gains.ki_x, gains.kd_x, ctrl.m_hat[..., 0], aff[..., 0])
    uy, my_hat = lateral(err[..., 1], integ[..., 1], sp.vel[..., 1], vel_world[..., 1],
                         gains.kp_y, gains.ki_y, gains.kd_y, ctrl.m_hat[..., 1], aff[..., 1])
    if tilt_clip is not None:
        lim = float(np.sin(tilt_clip))
        ux, uy = ux.clamp(-lim, lim), uy.clamp(-lim, lim)
    roll_des, pitch_des = _desired_tilt(ux, uy, sp.yaw)

    # attitude backstepping with adaptive nx/ny
    z1 = phi - roll_des
    z2 = p - (0.0 - gains.kp_roll * z1)
    nx = ctrl.n_hat[..., 0] + 3.0 * z2 * dt
    if n_hat_clip is not None:
        nx = nx.clamp(-n_hat_clip, n_hat_clip)
    u2 = (ixx / ylen) * (
        -gains.kp_roll * (z2 - gains.kp_roll * z1) - z1 - gains.kd_roll * z2
        - nx - xlen * tau_g[..., 0] / ixx
    ) + (1.0 / ylen) * ((izz - iyy) * q * r)

    z3 = theta - pitch_des
    z4 = q - (0.0 - gains.kp_pitch * z3)
    ny = ctrl.n_hat[..., 1] + 3.0 * z4 * dt
    if n_hat_clip is not None:
        ny = ny.clamp(-n_hat_clip, n_hat_clip)
    u3 = (iyy / xlen) * (
        -gains.kp_pitch * (z4 - gains.kd_pitch * z3) - z3 - gains.kd_pitch * z4
        - ny - ylen * tau_g[..., 1] / iyy
    ) + (1.0 / xlen) * ((ixx - izz) * p * r)

    z5 = psi - sp.yaw
    z6 = r - (sp.yaw_rate - gains.kp_yaw * z5)
    u4 = izz * (
        -gains.kp_yaw * (z6 - gains.kd_yaw * z5) - z5 - gains.kd_yaw * z6
        - tau_g[..., 2] / izz + z_mom / izz
    ) + (iyy - ixx) * p * q

    new_ctrl = FlightCtrlState(int_err=integ, prev_err=err,
                               m_hat=torch.stack([mx_hat, my_hat, mz_hat], -1),
                               n_hat=torch.stack([nx, ny], -1))
    return torch.stack([u1, u2, u3, u4], dim=-1), new_ctrl


def roll_pitch_yawrate_thrust_step(
    vehicle: MultirotorParams, roll_des: Tensor, pitch_des: Tensor, yaw_rate_des: Tensor,
    thrust: Tensor, rpy: Tensor, omega_body: Tensor, kp_rp: float = 100.0,
    kd_rp: float = 18.0, kd_yaw_rate: float = 10.0,
) -> Tensor:
    """Attitude-command law -> U = [T, tau] (body frame): RotorS'
    roll_pitch_yawrate_thrust controller, the joystick-flight path.  Tracks
    the commanded roll and pitch angles and the yaw *rate* with an
    inertia-normalized PD and passes the thrust through; stateless."""
    inertia = device_const(vehicle.inertia, rpy)
    tau_r = inertia[0] * (kp_rp * (roll_des - rpy[..., 0]) - kd_rp * omega_body[..., 0])
    tau_p = inertia[1] * (kp_rp * (pitch_des - rpy[..., 1]) - kd_rp * omega_body[..., 1])
    tau_y = inertia[2] * kd_yaw_rate * (yaw_rate_des - omega_body[..., 2])
    return torch.stack([thrust, tau_r, tau_p, tau_y], dim=-1)


def allocate(vehicle: MultirotorParams, u: Tensor) -> Tensor:
    """[T, tau_x, tau_y, tau_z] -> rotor speed commands through the
    allocation pseudo-inverse (ordered [tau, T]), negative squared speeds
    clamped to zero before the square root."""
    pinv = device_const(vehicle.allocation_pinv(), u)
    tau_t = torch.cat([u[..., 1:4], u[..., 0:1]], dim=-1)
    w2 = torch.einsum("ri,...i->...r", pinv, tau_t)
    return torch.sqrt(w2.clamp(min=0.0))
