"""Fixed-wing aerodynamics: the RotorS ``gazebo_fw_dynamics_plugin`` and
``liftdrag_plugin`` as batched plant and rollout models.

Port of the JAX package's ``models/fixed_wing.py``, term by term:

* :func:`fw_forces_moments`: the polynomial-coefficient airframe model
  (Techpod defaults): angle of attack and sideslip from the body airspeed,
  wind-frame force and moment polynomials in (alpha, beta, deflections,
  non-dimensional rates), throttle thrust, the wind -> body rotation.
  Elementwise over any leading dims, so one function serves the plant and
  the K-sample MPPI rollouts.
* :func:`liftdrag_wrench`: one stall-aware lift/drag surface element.
* :func:`step`: semi-implicit Euler integration of the rigid body with the
  Techpod's full inertia tensor (it has an ixz product).

The body frame is North-West-Up (x forward, y left, z up); the
aerodynamics are evaluated in North-East-Down and flipped back, as the
reference plugin does.  The YAML loaders import ``yaml`` only when called.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import rotations as rot
from ..utils.device import device_const, resolve_device

Tensor = torch.Tensor

GRAVITY = 9.81
AIR_DENSITY = 1.2041          # kAirDensity, gazebo_fw_dynamics_plugin.h
MIN_AIRSPEED = 0.1            # kMinAirSpeedThresh


@dataclasses.dataclass(frozen=True)
class FwAeroParams:
    """Aerodynamic coefficient polynomials (Techpod), constant term first."""

    alpha_max: float = 0.27
    alpha_min: float = -0.27
    c_drag_alpha: tuple = (0.1360, -0.6737, 5.4546)
    c_drag_beta: tuple = (0.0195, 0.0, -0.3842)
    c_drag_delta_ail: tuple = (0.0195, 1.4205e-4, 7.5037e-6)
    c_drag_delta_flp: tuple = (0.0195, 2.7395e-4, 1.23e-5)
    c_side_force_beta: tuple = (0.0, -0.3073)
    c_lift_alpha: tuple = (0.2127, 10.8060, -46.8324, 60.6017)
    c_lift_delta_ail: tuple = (0.3304, 0.0048)
    c_lift_delta_flp: tuple = (0.3304, 0.0073)
    c_roll_moment_beta: tuple = (0.0, -0.0154)
    c_roll_moment_p: tuple = (0.0, -0.1647)
    c_roll_moment_r: tuple = (0.0, 0.0117)
    c_roll_moment_delta_ail: tuple = (0.0, 0.0570)
    c_roll_moment_delta_flp: tuple = (0.0, 0.001)
    c_pitch_moment_alpha: tuple = (0.0435, -2.9690)
    c_pitch_moment_q: tuple = (-0.1173, -106.1541)
    c_pitch_moment_delta_elv: tuple = (-0.1173, -6.1308)
    c_yaw_moment_beta: tuple = (0.0, 0.0430)
    c_yaw_moment_r: tuple = (0.0, -0.0827)
    c_yaw_moment_delta_rud: tuple = (0.0, 0.06)
    c_thrust: tuple = (0.0, 14.7217, 0.0)


@dataclasses.dataclass(frozen=True)
class FwVehicleParams:
    """Airframe geometry and rigid-body properties of the Techpod: the
    assembled mass and the fuselage inertia tensor with its ixz product."""

    wing_span: float = 2.59
    wing_surface: float = 0.47
    chord_length: float = 0.18
    thrust_inclination: float = 0.0
    mass: float = 2.65
    inertia_diag: tuple = (0.16632, 0.3899, 0.5243)
    inertia_ixz: float = 0.0755
    deflection_limit: float = 0.349066   # +-20 deg for every surface
    ground_z: float = 0.0

    def inertia_matrix(self) -> np.ndarray:
        ixx, iyy, izz = self.inertia_diag
        ixz = self.inertia_ixz
        return np.array([[ixx, 0.0, ixz], [0.0, iyy, 0.0], [ixz, 0.0, izz]], np.float64)

    def inertia_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.inertia_matrix())


class FwControls(NamedTuple):
    """Normalized [-1, 1] surface commands and [0, 1] throttle; each input
    maps onto its surface's symmetric deflection range."""

    aileron_left: Tensor
    aileron_right: Tensor
    elevator: Tensor
    flap: Tensor
    rudder: Tensor
    throttle: Tensor


def controls_from_actuators(normalized: Tensor) -> FwControls:
    """Unpack the 6-channel normalized actuator array with the Techpod's
    channel map (ail_r=0, elev=1, flap=2, rudder=3, ail_l=4, throttle=5)."""
    return FwControls(aileron_left=normalized[..., 4], aileron_right=normalized[..., 0],
                      elevator=normalized[..., 1], flap=normalized[..., 2],
                      rudder=normalized[..., 3], throttle=normalized[..., 5])


def _poly(coeffs: tuple, x: Tensor) -> Tensor:
    """dot(coeffs, [1, x, x^2, ...]) with coeffs[0] the constant term."""
    acc = torch.zeros_like(x) + coeffs[0]
    xp = x
    for c in coeffs[1:]:
        acc = acc + c * xp
        xp = xp * x
    return acc


def _poly0(coeffs: tuple, x: Tensor) -> Tensor:
    """:func:`_poly` without the constant term."""
    return _poly((0.0,) + tuple(coeffs[1:]), x)


def fw_forces_moments(aero: FwAeroParams, veh: FwVehicleParams, v_air_body: Tensor,
                      omega_body: Tensor, controls: FwControls) -> tuple:
    """Body-frame (force, moment) of the polynomial airframe model from the
    NWU body-frame airspeed and body rates."""
    defl = veh.deflection_limit
    d_ail_l = controls.aileron_left * defl
    d_ail_r = controls.aileron_right * defl
    d_elev = controls.elevator * defl
    d_flap = controls.flap * defl
    d_rud = controls.rudder * defl

    # NWU -> NED component flips.
    u, v, w = v_air_body[..., 0], -v_air_body[..., 1], -v_air_body[..., 2]
    p, q, r = omega_body[..., 0], -omega_body[..., 1], -omega_body[..., 2]

    speed = torch.linalg.norm(v_air_body, dim=-1)
    slow = speed < MIN_AIRSPEED
    beta = torch.where(slow, 0.0, torch.asin(torch.clamp(v / speed.clamp(min=1e-6), -1.0, 1.0)))
    alpha = torch.where(u < MIN_AIRSPEED, 0.0, torch.atan2(w, u.clamp(min=1e-6)))
    alpha = torch.clamp(alpha, aero.alpha_min, aero.alpha_max)

    q_bar_s = 0.5 * AIR_DENSITY * speed * speed * veh.wing_surface
    ail_sum = d_ail_l + d_ail_r
    ail_diff = d_ail_l - d_ail_r
    flap_sum = 2.0 * d_flap
    flap_diff = torch.zeros_like(flap_sum)

    drag = q_bar_s * (_poly(aero.c_drag_alpha, alpha) + _poly0(aero.c_drag_beta, beta)
                      + _poly0(aero.c_drag_delta_ail, ail_sum)
                      + _poly0(aero.c_drag_delta_flp, flap_sum))
    side = q_bar_s * _poly0(aero.c_side_force_beta, beta)
    lift = q_bar_s * (_poly(aero.c_lift_alpha, alpha) + _poly0(aero.c_lift_delta_ail, ail_sum)
                      + _poly0(aero.c_lift_delta_flp, flap_sum))
    forces_wind = torch.stack([-drag, side, -lift], dim=-1)

    # Non-dimensional rates.
    safe_v = speed.clamp(min=MIN_AIRSPEED)
    p_hat = torch.where(slow, 0.0, p * veh.wing_span / (2.0 * safe_v))
    q_hat = torch.where(slow, 0.0, q * veh.chord_length / (2.0 * safe_v))
    r_hat = torch.where(slow, 0.0, r * veh.wing_span / (2.0 * safe_v))

    roll_m = q_bar_s * veh.wing_span * (
        _poly0(aero.c_roll_moment_beta, beta) + _poly0(aero.c_roll_moment_p, p_hat)
        + _poly0(aero.c_roll_moment_r, r_hat) + _poly0(aero.c_roll_moment_delta_ail, ail_diff)
        + _poly0(aero.c_roll_moment_delta_flp, flap_diff))
    pitch_m = q_bar_s * veh.chord_length * (
        _poly(aero.c_pitch_moment_alpha, alpha) + _poly0(aero.c_pitch_moment_q, q_hat)
        + _poly0(aero.c_pitch_moment_delta_elv, d_elev))
    yaw_m = q_bar_s * veh.wing_span * (
        _poly0(aero.c_yaw_moment_beta, beta) + _poly0(aero.c_yaw_moment_r, r_hat)
        + _poly0(aero.c_yaw_moment_delta_rud, d_rud))
    moments_wind = torch.stack([roll_m, pitch_m, yaw_m], dim=-1)

    thrust = _poly(aero.c_thrust, controls.throttle)
    incl = veh.thrust_inclination
    force_thrust_b = thrust[..., None] * device_const(
        [math.cos(incl), 0.0, math.sin(incl)], v_air_body)

    # Wind -> body rotation (the transpose of R_Wind_B).
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    zeros = torch.zeros_like(ca)
    r_wind_b = torch.stack([torch.stack([ca * cb, sb, sa * cb], dim=-1),
                            torch.stack([-sb * ca, cb, -sa * sb], dim=-1),
                            torch.stack([-sa, zeros, ca], dim=-1)], dim=-2)
    forces_ned = torch.einsum("...ji,...j->...i", r_wind_b, forces_wind) + force_thrust_b
    moments_ned = torch.einsum("...ji,...j->...i", r_wind_b, moments_wind)

    # NED -> NWU flips.
    flip = device_const([1.0, -1.0, -1.0], v_air_body)
    return forces_ned * flip, moments_ned * flip


class FixedWingState(NamedTuple):
    pos: Tensor    # (..., 3) world position
    quat: Tensor   # (..., 4) wxyz body -> world
    vel: Tensor    # (..., 3) world linear velocity
    omega: Tensor  # (..., 3) body angular velocity


def init_state(pos=(0.0, 0.0, 100.0), vel=(0.0, 0.0, 0.0), batch_shape=(),
               dtype=torch.float32, device="cuda") -> FixedWingState:
    dev = resolve_device(device)
    shape = tuple(batch_shape)

    def full(values):
        t = torch.tensor(values, dtype=dtype, device=dev)
        return t.expand(shape + t.shape).clone()

    return FixedWingState(pos=full(list(pos)), quat=full([1.0, 0.0, 0.0, 0.0]),
                          vel=full(list(vel)), omega=full([0.0, 0.0, 0.0]))


def step(aero: FwAeroParams, veh: FwVehicleParams, state: FixedWingState,
         controls: FwControls, dt: float, wind_world: Optional[Tensor] = None) -> FixedWingState:
    """One semi-implicit Euler step of the fixed-wing rigid body (batched
    over leading dims), with the full (non-diagonal) inertia tensor."""
    r = rot.quat_to_matrix(state.quat)
    airspeed_world = state.vel if wind_world is None else state.vel - wind_world
    v_air_b = torch.einsum("...ji,...j->...i", r, airspeed_world)
    force_b, moment_b = fw_forces_moments(aero, veh, v_air_b, state.omega, controls)

    acc = torch.einsum("...ij,...j->...i", r, force_b) / veh.mass
    acc = acc - device_const([0.0, 0.0, GRAVITY], state.pos)
    inertia = device_const(veh.inertia_matrix(), state.pos)
    inertia_inv = device_const(veh.inertia_inverse(), state.pos)
    iw = torch.einsum("ij,...j->...i", inertia, state.omega)
    omega_dot = torch.einsum("ij,...j->...i", inertia_inv,
                             moment_b - torch.linalg.cross(state.omega, iw, dim=-1))

    vel = state.vel + acc * dt
    pos = state.pos + vel * dt
    omega = state.omega + omega_dot * dt
    dq = rot.quat_from_axis_angle(omega * dt)
    quat = rot.quat_normalize(rot.quat_multiply(state.quat, dq))
    return FixedWingState(pos=pos, quat=quat, vel=vel, omega=omega)


# ---------------------------------------------------------------------------
# Per-surface lift/drag element (liftdrag_plugin)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LiftDragParams:
    """One aerodynamic surface."""

    cla: float = 1.0            # lift-curve slope dCl/dalpha
    cda: float = 0.01           # drag-curve slope
    cma: float = 0.01           # moment-curve slope
    alpha_stall: float = 0.5 * math.pi
    cla_stall: float = 0.0      # post-stall slopes
    cda_stall: float = 1.0
    cma_stall: float = 0.0
    alpha0: float = 0.0         # zero-lift angle of attack offset
    area: float = 1.0
    air_density: float = 1.2041
    forward: tuple = (1.0, 0.0, 0.0)   # link-frame -drag direction
    upward: tuple = (0.0, 0.0, 1.0)    # link-frame +lift direction
    cp: tuple = (0.0, 0.0, 0.0)        # center of pressure, link frame
    radial_symmetry: bool = False
    control_joint_rad_to_cl: float = 0.0


def _unit(x: Tensor) -> Tensor:
    return x / torch.linalg.norm(x, dim=-1).clamp(min=1e-9)[..., None]


def _stall(alpha: Tensor, a_s: float, slope: float, stall_slope: float, sweep: Tensor,
           clamp: bool) -> Tensor:
    """The piecewise-linear coefficient: linear below the stall angle, the
    post-stall slope past it (clamped at 0 toward the other sign for lift
    and moment)."""
    pre = slope * alpha * sweep
    hi = (slope * a_s + stall_slope * (alpha - a_s)) * sweep
    lo = (-slope * a_s + stall_slope * (alpha + a_s)) * sweep
    if clamp:
        hi, lo = hi.clamp(min=0.0), lo.clamp(max=0.0)
    return torch.where(alpha > a_s, hi, torch.where(alpha < -a_s, lo, pre))


def liftdrag_wrench(params: LiftDragParams, rot_body_world: Tensor, vel_world_at_cp: Tensor,
                    control_angle=0.0) -> tuple:
    """World-frame (force, torque about the link origin) of one lift/drag
    surface: the inflow decomposed in the lift-drag plane, alpha from the
    lift direction against the link's upward vector, the stall model with
    sweep correction, the control-joint cl increment, and the cp offset
    moment plus the cm moment about the spanwise axis.  The in-plane
    velocity keeps the reference's subtraction of the spanwise component
    along the velocity direction."""
    vel = vel_world_at_cp
    speed = torch.linalg.norm(vel, dim=-1)
    vel_i = vel / speed.clamp(min=1e-9)[..., None]

    forward_i = torch.einsum("...ij,j->...i", rot_body_world,
                             device_const(params.forward, vel))
    if params.radial_symmetry:
        tmp = torch.linalg.cross(forward_i, vel_i, dim=-1)
        upward_i = _unit(torch.linalg.cross(forward_i, tmp, dim=-1))
    else:
        upward_i = torch.einsum("...ij,j->...i", rot_body_world,
                                device_const(params.upward, vel))
    spanwise_i = _unit(torch.linalg.cross(forward_i, upward_i, dim=-1))

    sin_sweep = torch.clamp(torch.sum(spanwise_i * vel_i, dim=-1), -1.0, 1.0)
    cos_sweep2 = 1.0 - sin_sweep * sin_sweep
    vel_ld = vel - torch.sum(vel * spanwise_i, dim=-1, keepdim=True) * vel_i

    drag_dir = -vel_ld / torch.linalg.norm(vel_ld, dim=-1).clamp(min=1e-9)[..., None]
    lift_i = _unit(torch.linalg.cross(spanwise_i, vel_ld, dim=-1))

    cos_alpha = torch.clamp(torch.sum(lift_i * upward_i, dim=-1), -1.0, 1.0)
    sign = torch.where(torch.sum(lift_i * forward_i, dim=-1) >= 0.0, 1.0, -1.0)
    alpha = params.alpha0 + sign * torch.acos(cos_alpha)
    alpha = torch.where(alpha > 0.5 * math.pi, alpha - math.pi, alpha)
    alpha = torch.where(alpha < -0.5 * math.pi, alpha + math.pi, alpha)

    speed_ld = torch.linalg.norm(vel_ld, dim=-1)
    q_dyn = 0.5 * params.air_density * speed_ld * speed_ld

    a_s = params.alpha_stall
    cl = _stall(alpha, a_s, params.cla, params.cla_stall, cos_sweep2, True)
    cl = cl + params.control_joint_rad_to_cl * control_angle
    cd = torch.abs(_stall(alpha, a_s, params.cda, params.cda_stall, cos_sweep2, False))
    cm = _stall(alpha, a_s, params.cma, params.cma_stall, cos_sweep2, True)

    qa = (q_dyn * params.area)[..., None]
    force = cl[..., None] * qa * lift_i + cd[..., None] * qa * drag_dir
    moment = cm[..., None] * qa * spanwise_i
    # Negligible inflow produces no wrench.
    active = (speed > 0.01)[..., None]
    force = torch.where(active, force, 0.0)
    cp_world = torch.einsum("...ij,j->...i", rot_body_world, device_const(params.cp, vel))
    torque = torch.linalg.cross(cp_world, force, dim=-1) + torch.where(active, moment, 0.0)
    return force, torque


def aero_params_from_yaml(path: str) -> FwAeroParams:
    """Aerodynamic coefficients from a RotorS fixed-wing YAML: flat keys
    named as the :class:`FwAeroParams` fields, vectors as lists.  Unknown
    keys are ignored; absent keys keep the Techpod defaults."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    names = {f.name for f in dataclasses.fields(FwAeroParams)}
    kwargs = {k: tuple(v) if isinstance(v, (list, tuple)) else float(v)
              for k, v in data.items() if k in names}
    return FwAeroParams(**kwargs)


def vehicle_params_from_yaml(path: str) -> FwVehicleParams:
    """Airframe geometry from a RotorS fixed-wing vehicle YAML.  The one
    symmetric deflection limit is the first control surface's
    ``deflection_max``; mass and inertia are not in that YAML and keep the
    defaults."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    kwargs = {k: float(data[k]) for k in ("wing_span", "wing_surface", "chord_length",
                                          "thrust_inclination") if k in data}
    for surface in ("aileron_left", "aileron_right", "elevator", "flap", "rudder"):
        sub = data.get(surface)
        if isinstance(sub, dict) and "deflection_max" in sub:
            kwargs["deflection_limit"] = abs(float(sub["deflection_max"]))
            break
    return FwVehicleParams(**kwargs)
