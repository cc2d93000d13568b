"""Whole-body quadrotor + 7-DoF-arm model for MPPI rollouts.

Port of the JAX package's ``models/whole_body.py`` (the parallel-in-time
rollouts).  The base runs in one of three action modes (attitude
setpoints through a PD-closed attitude loop, position setpoints through the
identified closed position loop, or the direct wrench with a quaternion
prefix scan); the arm's joint accelerations are double-integrated and the
limit-clamped joints feed the quaternion FK.  Every horizon recurrence is a
host-precomputed (H, H) operator — this operator form is the plain version
the CUDA cost kernel, which runs the same recurrences step by step in
registers, is held against.

The rollouts take leading scenario dims, as ``jax.vmap`` of the JAX model
does: a state with fields (*B, D) rolls out actions (*B, K, H, A) into
trajectories (*B, K, H, ...); with no leading dims the ops are the
unbatched ones.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import integrators
from ..utils import rotations as rot
from ..utils.device import device_const
from ..utils.pose import Pose
from . import chain as chain_mod
from . import kinova
from .chain import ChainSpec
from .multirotor import Multirotor12State, MultirotorParams
from .rigid_body import InertialParams

Tensor = torch.Tensor

N_BASE_ACTIONS = 4  # [thrust, tau_x, tau_y, tau_z] or the mode's setpoints


@dataclass(frozen=True)
class WholeBodyParams:
    vehicle: MultirotorParams = MultirotorParams()
    arm_tip: str = "link_7"
    arm_mass_lump: float = 5.54
    couple_arm_gravity: bool = True
    drag_kd: float = 0.0
    # "attitude" | "position" | "wrench" — see the JAX package for each
    # mode's action space.
    control_mode: str = "attitude"
    att_kp_rp: float = 100.0
    att_kd_rp: float = 18.0
    att_kp_yaw: float = 20.0
    att_kd_yaw: float = 9.0
    pos_kp_xy: float = 1.7
    pos_kd_xy: float = 2.1
    pos_kp_z: float = 9.0
    pos_kd_z: float = 5.4
    time_parallel: bool = True
    rotor_lag_tau: float = 0.02
    rate_damping: float = 0.0

    def chain(self) -> ChainSpec:
        return kinova.chain(self.arm_tip)

    def inertials(self) -> InertialParams:
        return kinova.inertials()


class WholeBodyState(NamedTuple):
    base: Multirotor12State
    q: Tensor      # (…, 7)
    qdot: Tensor   # (…, 7)


class BaseTraj(NamedTuple):
    """Base trajectory over (K, H): world position/velocity, body->world
    quaternion (wxyz), body rates."""

    pos: Tensor    # (K, H, 3)
    quat: Tensor   # (K, H, 4)
    vel: Tensor    # (K, H, 3)
    omega: Tensor  # (K, H, 3)

    def tilt_squared(self) -> Tensor:
        """R[0,2]^2 + R[1,2]^2 of the body z axis, from the quaternion."""
        w, x, y, z = self.quat.unbind(-1)
        r02 = 2.0 * (x * z + w * y)
        r12 = 2.0 * (y * z - w * x)
        return r02 * r02 + r12 * r12


def base_rotation(base: Multirotor12State) -> Tensor:
    """Body->world rotation from the reduced state's rpy."""
    angles = torch.stack(
        [base.rpy[..., 2], base.rpy[..., 1], base.rpy[..., 0]], dim=-1
    )
    return rot.euler_to_matrix(angles, "ZYX")


def arm_gravity_torque_fast(
    spec: ChainSpec, inertials: InertialParams, q: Tensor, base_rot: Tensor,
) -> Tensor:
    """Gravity moment of the arm about the base origin, base frame:
    tau = sum_i m_i (c_i x g_b), COM positions from the quaternion chain."""
    coms = chain_mod.link_positions_posquat(spec, q, inertials.com)  # [..., J, 3]
    g_b = -9.81 * base_rot.transpose(-1, -2)[..., :, 2]
    masses = device_const(inertials.mass, q)
    cross = torch.linalg.cross(coms, g_b[..., None, :].expand_as(coms), dim=-1)
    return torch.einsum("...ji,j->...i", cross, masses)


# ---------------------------------------------------------------------------
# Host-side horizon operators (float64 NumPy)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _drag_decay_operator(h: int, alpha: float) -> Tuple[np.ndarray, np.ndarray]:
    """v_t = alpha^{t+1} v_0 + sum_{s<=t} alpha^{t-s} dt a_s as (D (H, H),
    hom (H,)); alpha = 1 degenerates to the plain cumsum."""
    d = np.zeros((h, h))
    for t in range(h):
        d[t, : t + 1] = alpha ** np.arange(t, -1, -1)
    hom = alpha ** np.arange(1, h + 1)
    return d, hom


def _rotor_lag_matrix(h: int, dt: float, tau: float) -> np.ndarray:
    """First-order lag y_t = alpha y_{t-1} + (1-alpha) u_t with y primed at
    u_0, as an (H, H) lower-triangular convolution."""
    alpha = float(np.exp(-dt / tau))
    f = np.zeros((h, h))
    for t in range(h):
        for s in range(t + 1):
            f[t, s] = (1.0 - alpha) * alpha ** (t - s)
        f[t, 0] += alpha ** (t + 1)
    return f


def _attitude_response_pair(dt: float, kp: float, kd: float):
    """(A, B) of the PD-closed axis x' = A x + B u with x = (phi, omega)."""
    a = np.array([[1.0 - dt * dt * kp, dt * (1.0 - dt * kd)],
                  [-dt * kp, 1.0 - dt * kd]])
    b = np.array([dt * dt * kp, dt * kp])
    return a, b


@functools.lru_cache(maxsize=None)
def _attitude_response_matrices(h: int, dt: float, kp: float, kd: float):
    """(g_phi (H, H), g_omega (H, H), hom (H, 2, 2)) with
    x_t = A^{t+1} x_0 + sum_{s<=t} A^{t-s} B u_s."""
    a, b = _attitude_response_pair(dt, kp, kd)
    g_phi = np.zeros((h, h))
    g_omega = np.zeros((h, h))
    hom = np.zeros((h, 2, 2))
    pows = [np.eye(2)]
    for _ in range(h):
        pows.append(a @ pows[-1])
    for t in range(h):
        hom[t] = pows[t + 1]
        for s in range(t + 1):
            ab = pows[t - s] @ b
            g_phi[t, s] = ab[0]
            g_omega[t, s] = ab[1]
    return g_phi, g_omega, hom


def _kh(x: Tensor) -> Tensor:
    """A state vector (*B, D) lifted to broadcast over samples and steps:
    (*B, 1, 1, D)."""
    return x[..., None, None, :]


def _drag_velocity(drag_kd: float, dt: float, vel0: Tensor, acc: Tensor) -> Tensor:
    """Velocity trajectory under linear drag from the (*B, K, H, 3)
    acceleration sequence and the (*B, 3) initial velocity; plain cumsum
    when drag is off."""
    if not drag_kd:
        return _kh(vel0) + torch.cumsum(acc * dt, dim=-2)
    d, hom = _drag_decay_operator(acc.shape[-2], 1.0 - dt * drag_kd)
    return (torch.einsum("ts,...si->...ti", device_const(d, acc), acc * dt)
            + device_const(hom, acc)[:, None] * _kh(vel0))


def _quat_from_rpy(rpy: Tensor) -> Tensor:
    """Elementwise (roll, pitch, yaw) -> wxyz quaternion qz(y) qy(p) qx(r)."""
    half = 0.5 * rpy
    cr, sr = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cp, sp = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cy, sy = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    return torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1)


def _z_world(quat: Tensor) -> Tensor:
    w, x, y, z = quat.unbind(-1)
    return torch.stack(
        [2.0 * (x * z + w * y), 2.0 * (y * z - w * x), 1.0 - 2.0 * (x * x + y * y)],
        dim=-1,
    )


def _gravity(like: Tensor) -> Tensor:
    return torch.stack([torch.zeros_like(like), torch.zeros_like(like),
                        torch.zeros_like(like) + 9.81], dim=-1)


def _quat_prefix_scan(q: Tensor) -> Tensor:
    """Inclusive prefix product along H (axis -2), earlier factors on the
    left — a Hillis-Steele scan of log2(H) rounds."""
    h = q.shape[-2]
    ident = torch.zeros_like(q)
    ident[..., 0] = 1.0
    s = 1
    while s < h:
        shifted = torch.cat([ident[..., :s, :], q[..., :-s, :]], dim=-2)
        q = rot.quat_multiply(shifted, q)
        s *= 2
    return q


def _base_rollout_parallel(
    params: WholeBodyParams, state: WholeBodyState, base_u: Tensor, dt: float
) -> BaseTraj:
    """Direct-wrench rollout: damped body rates, quaternion prefix scan for
    attitude, thrust -> acceleration -> (drag-decayed) velocity -> position."""
    m = params.vehicle.mass + params.arm_mass_lump
    inertia = device_const(np.asarray(params.vehicle.inertia, np.float64), base_u)
    omega = _drag_velocity(params.rate_damping, dt, state.base.omega, base_u[..., 1:4] / inertia)
    dq = rot.quat_from_axis_angle(omega * dt)
    prefix = _quat_prefix_scan(dq)
    q0 = rot.matrix_to_quat(base_rotation(state.base))
    quat = rot.quat_multiply(_kh(q0), prefix)
    acc = _z_world(quat) * base_u[..., 0:1] / m - _gravity(base_u[..., 0])
    vel = _drag_velocity(params.drag_kd, dt, state.base.vel, acc)
    pos = _kh(state.base.pos) + torch.cumsum(vel * dt, dim=-2)
    return BaseTraj(pos=pos, quat=quat, vel=vel, omega=omega)


def _base_rollout_attitude(
    params: WholeBodyParams, state: WholeBodyState, base_u: Tensor, dt: float
) -> BaseTraj:
    """Attitude-setpoint rollout: base_u = (*B, K, H, 4) = [thrust,
    rpy_des]; the PD-closed axes are (H, H) response operators plus the
    initial state's homogeneous term (omega0 treated as euler rates)."""
    h = base_u.shape[-2]
    m = params.vehicle.mass + params.arm_mass_lump
    rpy0, om0 = state.base.rpy, state.base.omega
    gains = [(params.att_kp_rp, params.att_kd_rp)] * 2 + [(params.att_kp_yaw, params.att_kd_yaw)]
    phis, oms = [], []
    for i, (kp, kd) in enumerate(gains):
        g_phi, g_om, hom = _attitude_response_matrices(h, dt, kp, kd)
        x0 = torch.stack([rpy0[..., i], om0[..., i]], dim=-1)
        hom_traj = torch.einsum("hij,...j->...hi", device_const(hom, base_u), x0)
        u = base_u[..., 1 + i]
        phis.append(torch.einsum("ts,...ks->...kt", device_const(g_phi, u), u)
                    + hom_traj[..., None, :, 0])
        oms.append(torch.einsum("ts,...ks->...kt", device_const(g_om, u), u)
                   + hom_traj[..., None, :, 1])
    quat = _quat_from_rpy(torch.stack(phis, dim=-1))
    omega = torch.stack(oms, dim=-1)
    acc = _z_world(quat) * base_u[..., 0:1] / m - _gravity(base_u[..., 0])
    vel = _drag_velocity(params.drag_kd, dt, state.base.vel, acc)
    pos = _kh(state.base.pos) + torch.cumsum(vel * dt, dim=-2)
    return BaseTraj(pos=pos, quat=quat, vel=vel, omega=omega)


def _base_rollout_position(
    params: WholeBodyParams, state: WholeBodyState, base_u: Tensor, dt: float
) -> BaseTraj:
    """Position-setpoint rollout: base_u = (*B, K, H, 4) = [xyz offsets,
    yaw]; each axis is the identified 2nd-order response to the absolute
    setpoint pos0 + offset, and the implied small-angle attitude feeds the
    FK."""
    h = base_u.shape[-2]
    pos0, vel0 = state.base.pos, state.base.vel
    setpoints = _kh(pos0) + base_u[..., 0:3]
    gains = [(params.pos_kp_xy, params.pos_kd_xy)] * 2 + [(params.pos_kp_z, params.pos_kd_z)]
    ps, vs, accs = [], [], []
    for i, (kp, kd) in enumerate(gains):
        g_phi, g_om, hom = _attitude_response_matrices(h, dt, kp, kd)
        u = setpoints[..., i]
        x0 = torch.stack([pos0[..., i], vel0[..., i]], dim=-1)
        hom_traj = torch.einsum("hij,...j->...hi", device_const(hom, u), x0)
        p = torch.einsum("ts,...ks->...kt", device_const(g_phi, u), u) + hom_traj[..., None, :, 0]
        v = torch.einsum("ts,...ks->...kt", device_const(g_om, u), u) + hom_traj[..., None, :, 1]
        ps.append(p)
        vs.append(v)
        accs.append(kp * (u - p) - kd * v)
    inv_g = 1.0 / 9.81
    rpy = torch.stack([-accs[1] * inv_g, accs[0] * inv_g, base_u[..., 3]], dim=-1)
    omega = torch.cat(
        [torch.zeros_like(rpy[..., :1, :]), torch.diff(rpy, dim=-2) / dt], dim=-2
    )
    return BaseTraj(pos=torch.stack(ps, -1), quat=_quat_from_rpy(rpy),
                    vel=torch.stack(vs, -1), omega=omega)


def rollout(
    params: WholeBodyParams, state: WholeBodyState, actions: Tensor, dt: float,
) -> Tuple[Pose, Tensor, Tensor, BaseTraj]:
    """Roll K sampled action sequences (*B, K, H, 4 + J) from one initial
    state per scenario (fields (*B, D)).

    Returns (EE Pose over (*B, K, H), raw joint q (*B, K, H, J), qdot,
    BaseTraj).  The raw q feeds the joint-limit costs; the limit-clamped q
    feeds the FK and the gravity moment (real joints stop at their stops)."""
    spec = params.chain()
    h = actions.shape[-2]
    base_u = actions[..., :N_BASE_ACTIONS]
    arm_u = actions[..., N_BASE_ACTIONS:]

    q, qdot = integrators.double_integrate(arm_u, state.q[..., None, :], state.qdot[..., None, :],
                                           dt)
    q_fk = torch.minimum(torch.maximum(q, device_const(spec.lower, q)), device_const(spec.upper, q))

    if params.control_mode == "position":
        base_traj = _base_rollout_position(params, state, base_u, dt)
    elif params.control_mode == "attitude":
        if params.rotor_lag_tau > 0.0:
            f = device_const(_rotor_lag_matrix(h, dt, params.rotor_lag_tau), base_u)
            thrust = torch.einsum("ts,...ks->...kt", f, base_u[..., 0])[..., None]
            base_u = torch.cat([thrust, base_u[..., 1:4]], dim=-1)
        base_traj = _base_rollout_attitude(params, state, base_u, dt)
    elif params.control_mode == "wrench":
        if not params.time_parallel:
            raise ValueError("only the parallel-in-time wrench rollout is ported")
        if params.rotor_lag_tau > 0.0:
            f = device_const(_rotor_lag_matrix(h, dt, params.rotor_lag_tau), base_u)
            base_u = torch.einsum("ts,...ksa->...kta", f, base_u)
        if params.couple_arm_gravity:
            # Quasi-static coupling at the initial attitude: only the
            # configuration-dependent moment of the arm's weight.
            tau_b = arm_gravity_torque_fast(
                spec, params.inertials(), q_fk, base_rotation(state.base)[..., None, None, :, :]
            )
            base_u = torch.cat([base_u[..., 0:1], base_u[..., 1:4] + tau_b], dim=-1)
        base_traj = _base_rollout_parallel(params, state, base_u, dt)
    else:
        raise ValueError(f"unknown control mode {params.control_mode!r}")

    ee_pos, ee_quat = chain_mod.forward_kinematics_posquat(
        spec, q_fk, base_pos=base_traj.pos, base_quat=base_traj.quat
    )
    return Pose(position=ee_pos, quat=ee_quat), q, qdot, base_traj


def hover_nominal_action(
    params: WholeBodyParams, n_horizon: int, dtype=torch.float32, device=None,
) -> Tensor:
    """Warm-start nominal: gravity-balancing thrust, zero torques/accels."""
    u0 = torch.zeros(N_BASE_ACTIONS + kinova.N_JOINTS, dtype=dtype)
    u0[0] = (params.vehicle.mass + params.arm_mass_lump) * 9.81
    return u0.to(device).expand(n_horizon, u0.shape[0]).clone()
