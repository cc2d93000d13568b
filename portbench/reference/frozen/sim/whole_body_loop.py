"""Whole-body closed loop: MPPI base + arm actions driving the full plant.

A frozen copy of the port's ``sim/whole_body_loop.py``, cut to the eager
free-flight loop the benchmark's reference runs.  Every 10 ms control step
solves the whole-body MPPI problem, servos the arm setpoint onto the
measured end-effector pose error, turns it into joint torques with the
reference's inertia-weighted tracking law, and runs ``substeps`` 1 kHz
physics steps of the full plant: the quaternion octorotor with rotor lag
(``models/multirotor``), the arm's forward dynamics under the tilted
gravity field (``models/rigid_body``: per substep, or on the control step's
frozen coefficients with ``arm_coeffs_per_control``), the arm gravity
moment acting back on the base, and the base controller of the mode
(attitude PD, position backstepping or direct wrench).

With ``n_scenarios=B`` the episode runs B vehicles at once: every field of
the plant, the solver state and the targets with a leading B, one batched
solve per control step, the logs (B, n_control_steps).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..models import chain as chain_mod
from ..models import kinova
from ..models import multirotor as mr
from ..models import rigid_body as rb
from ..models.chain import ChainSpec
from ..models.multirotor import Multirotor12State, MultirotorParams, MultirotorState
from ..models.rigid_body import InertialParams
from ..models.whole_body import WholeBodyState, _base_rollout_position, arm_gravity_torque_fast
from ..solver import whole_body as wbs
from ..utils import rotations as rot
from ..utils.device import device_const, resolve_device
from ..utils.pose import Pose
from . import flight_control as fc

Tensor = torch.Tensor


def rpy_of(state: MultirotorState) -> Tensor:
    """Plant attitude as (roll, pitch, yaw)."""
    ang = rot.matrix_to_euler(rot.quat_to_matrix(state.quat), "ZYX")
    return torch.stack([ang[..., 2], ang[..., 1], ang[..., 0]], dim=-1)


@dataclass(frozen=True)
class WholeBodyLoopConfig:
    """The loop's configuration (the port's fields that the free-flight
    eager loop reads)."""

    physics_dt: float = 0.001
    substeps: int = 10
    track_kp: float = 400.0
    track_kd: float = 40.0
    setpoint_lookahead: int = 10
    tube_gain: Optional[float] = None     # None: 1.5 in wrench mode, else 0.8
    tube_radius: Optional[float] = None   # None: 0.3 in position mode, else 0.08
    tube_mu: float = 3e-4
    tube_clip: float = 0.05
    tube_ori_weight: float = 0.3
    mass_matrix_per_control: bool = False
    arm_coeffs_per_control: bool = False


class WholeBodyPlant(NamedTuple):
    base: MultirotorState      # full quaternion plant
    q: Tensor                  # (7,)
    qdot: Tensor               # (7,)
    ctrl: fc.FlightCtrlState   # inner-loop state (position mode)


class WholeBodyLog(NamedTuple):
    """Per-control-step telemetry.  ``l1_cmd`` is the reference's reach
    metric: L1 position error of the FK of the commanded qdes at the
    measured base pose (gate 5 mm); ``ee_err``/``l1_meas`` measure the
    plant's end effector."""

    ee_err: Tensor    # L2 measured EE position error [m]
    base_pos: Tensor  # (3,)
    tilt: Tensor      # |(roll, pitch)| [rad]
    l1_cmd: Tensor    # reference reach-gate metric [m]
    l1_meas: Tensor   # L1 measured EE position error [m]
    ori_err: Tensor   # measured EE geodesic orientation error [rad]


@dataclass(frozen=True, eq=False)
class PlantPhysics:
    """What :func:`physics_tick` needs of a configuration.  ``model`` (the
    solver's WholeBodyParams) supplies the attitude-mode PD gains and the
    wrench-mode coupling and rate damping; ``inertials`` the per-substep
    RNEA."""

    vehicle: MultirotorParams
    spec: ChainSpec
    dt: float
    extra_mass: float
    gains: fc.FlightGains = field(default_factory=fc.FlightGains)
    mode: str = "position"
    arm_coeffs_per_control: bool = True
    mass_matrix_per_control: bool = False
    inertials: Optional[InertialParams] = None
    model: Any = None


def init_plant(vehicle: MultirotorParams, pos=(0.0, 0.0, 2.1), q0=None,
               extra_mass: float = 5.54, dtype=torch.float32,
               device="cuda") -> WholeBodyPlant:
    """Hover at ``pos`` with the arm at ``q0`` (default: home).  ``pos``
    (B, 3) gives B vehicles, every field with a leading B."""
    dev = resolve_device(device)
    lead = tuple(np.shape(pos))[:-1]
    if not lead:
        base = mr.init_state(vehicle, pos=pos, dtype=dtype, device=dev)
    else:
        base = mr.init_state(vehicle, batch_shape=lead, dtype=dtype, device=dev)
        base = base._replace(pos=torch.as_tensor(np.asarray(pos), dtype=dtype).to(dev))
    base = base._replace(rotor_speed=torch.full(
        lead + (vehicle.n_rotors,), vehicle.hover_rotor_speed(extra_mass), dtype=dtype,
        device=dev))
    q = torch.as_tensor(kinova.Q_HOME if q0 is None else q0, dtype=dtype).to(dev)
    ctrl = fc.init_ctrl_state(vehicle.mass + extra_mass, dtype, dev)
    return WholeBodyPlant(
        base=base, q=q.expand(lead + (7,)).clone(),
        qdot=torch.zeros(lead + (7,), dtype=dtype, device=dev),
        ctrl=fc.FlightCtrlState(*(f.expand(lead + f.shape).clone() for f in ctrl)))


def observe(plant: WholeBodyPlant) -> WholeBodyState:
    """Full plant -> the solver's reduced observation."""
    base12 = Multirotor12State(pos=plant.base.pos, rpy=rpy_of(plant.base),
                               vel=plant.base.vel, omega=plant.base.omega)
    return WholeBodyState(base=base12, q=plant.q, qdot=plant.qdot)


def physics_tick(ph: PlantPhysics, plant: WholeBodyPlant, action_cmd: Tensor,
                 tau_arm_pd: Tensor, dyn) -> WholeBodyPlant:
    """One 1 kHz physics step (batched over leading dims).  ``dyn`` is the
    control step's FrozenArmCoeffs (``arm_coeffs_per_control``), the
    Cholesky factor of M (``mass_matrix_per_control``) or unused."""
    dt = ph.dt
    quat = plant.base.quat
    if ph.arm_coeffs_per_control:
        # a0 = R^T (0, 0, g) = g * (third row of R), off the quaternion.
        w, x, y, z = quat.unbind(-1)
        a0 = 9.81 * torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                                 1.0 - 2.0 * (x * x + y * y)], dim=-1)
        qdd = rb.frozen_forward_dynamics(dyn, a0, plant.qdot, tau_arm_pd)
        tau_g = rb.frozen_gravity_torque_on_base(dyn, a0)
    else:
        base_rot = rot.quat_to_matrix(quat)
        if ph.mass_matrix_per_control:
            qdd = rb.forward_dynamics_chol(ph.spec, ph.inertials, plant.q, plant.qdot,
                                           tau_arm_pd, dyn, base_rot=base_rot)
        else:
            qdd = rb.forward_dynamics(ph.spec, ph.inertials, plant.q, plant.qdot,
                                      tau_arm_pd, base_rot=base_rot)
        tau_g = arm_gravity_torque_fast(ph.spec, ph.inertials, plant.q, base_rot)
    # Hard joint stops: q clamps at the limits and the velocity into a stop
    # zeroes, keyed on the unclamped position.
    qdot = plant.qdot + qdd * dt
    q_raw = plant.q + qdot * dt
    q_lo, q_hi = device_const(ph.spec.lower, q_raw), device_const(ph.spec.upper, q_raw)
    q = torch.minimum(torch.maximum(q_raw, q_lo), q_hi)
    qdot = torch.where((q_raw < q_lo) | (q_raw > q_hi), 0.0, qdot)
    ctrl = plant.ctrl

    if ph.mode == "attitude":
        # Plant-side attitude PD plus the arm gravity-moment feed-forward.
        mp = ph.model
        inertia = device_const(ph.vehicle.inertia, q)
        kp = device_const([mp.att_kp_rp, mp.att_kp_rp, mp.att_kp_yaw], q)
        kd = device_const([mp.att_kd_rp, mp.att_kd_rp, mp.att_kd_yaw], q)
        tau = inertia * (kp * (action_cmd[..., 1:4] - rpy_of(plant.base))
                         - kd * plant.base.omega) - tau_g
        wrench_cmd = torch.cat([action_cmd[..., 0:1], tau], dim=-1)
    elif ph.mode == "position":
        # Backstepping inner loop tracks the position setpoint.
        zeros = torch.zeros_like(action_cmd[..., 0:3])
        sp = fc.FlightSetpoint(pos=action_cmd[..., 0:3], vel=zeros, yaw=action_cmd[..., 3],
                               yaw_rate=zeros[..., 0])
        wrench_cmd, ctrl = fc.backstepping_step(
            ph.gains, ph.vehicle, ctrl, sp, pos=plant.base.pos, vel_world=plant.base.vel,
            rpy=rpy_of(plant.base), omega_body=plant.base.omega, dt=dt, tau_g=tau_g,
        )
    else:
        # Direct wrench, with the arm gravity-moment feed-forward when the
        # solver's model does not carry the coupling, and the 1 kHz
        # body-rate damping the rollout models.
        mp = ph.model
        tau_cmd = action_cmd[..., 1:4]
        if not mp.couple_arm_gravity:
            tau_cmd = tau_cmd - tau_g
        if mp.rate_damping:
            tau_cmd = tau_cmd - mp.rate_damping * (
                device_const(ph.vehicle.inertia, q) * plant.base.omega)
        wrench_cmd = torch.cat([action_cmd[..., 0:1], tau_cmd], dim=-1)

    ext = (torch.zeros_like(tau_g), tau_g)
    base = mr.step(ph.vehicle, plant.base, fc.allocate(ph.vehicle, wrench_cmd), dt,
                   extra_mass=ph.extra_mass, external_wrench_body=ext)
    return WholeBodyPlant(base=base, q=q, qdot=qdot, ctrl=ctrl)


def pose_error_jacobian(spec: ChainSpec, q: Tensor, base_pos: Tensor, base_quat: Tensor,
                        ee_target: Pose, ori_weight: float):
    """The tube servo's 6-vector EE pose residual err6 = [p* - p,
    w 2 sign(qe_w) qe_vec] with qe = q* conj(q_ee), and its (6, J)
    Jacobian in q, each with the leading dims of ``q``.  The Jacobian is
    exact, in closed form from the joint frames: dp/dq_j = z_j x (p - o_j)
    and dqe/dq_j = qe [0, -z_j] / 2."""
    origins, axes, p, ee_q = chain_mod.joint_frames_posquat(spec, q, base_pos, base_quat)
    qe = rot.quat_multiply(ee_target.quat, rot.quat_conjugate(ee_q))
    # Small-angle rotation vector 2 sign(w) vec: the short way round.
    sgn = torch.sign(qe[..., 0:1])
    err6 = torch.cat([ee_target.position - p, ori_weight * 2.0 * sgn * qe[..., 1:]], dim=-1)
    d_pos = -torch.linalg.cross(axes, p[..., None, :] - origins, dim=-1)         # (..., J, 3)
    d_ori = -ori_weight * sgn[..., None, :] * (
        qe[..., None, 0:1] * axes
        + torch.linalg.cross(qe[..., None, 1:].expand_as(axes), axes, dim=-1))
    return err6, torch.cat([d_pos, d_ori], dim=-1).transpose(-1, -2)


def pose_error_jacobian(spec: ChainSpec, q: Tensor, base_pos: Tensor, base_quat: Tensor,
                        ee_target: Pose, ori_weight: float):
    """The tube servo's 6-vector EE pose residual err6 = [p* - p,
    w 2 sign(qe_w) qe_vec] with qe = q* conj(q_ee), and its (6, J)
    Jacobian in q, each with the leading dims of ``q``.  The Jacobian is
    exact, in closed form from the joint frames: dp/dq_j = z_j x (p - o_j)
    and dqe/dq_j = qe [0, -z_j] / 2."""
    origins, axes, p, ee_q = chain_mod.joint_frames_posquat(spec, q, base_pos, base_quat)
    qe = rot.quat_multiply(ee_target.quat, rot.quat_conjugate(ee_q))
    # Small-angle rotation vector 2 sign(w) vec: the short way round.
    sgn = torch.sign(qe[..., 0:1])
    err6 = torch.cat([ee_target.position - p, ori_weight * 2.0 * sgn * qe[..., 1:]], dim=-1)
    d_pos = -torch.linalg.cross(axes, p[..., None, :] - origins, dim=-1)         # (..., J, 3)
    d_ori = -ori_weight * sgn[..., None, :] * (
        qe[..., None, 0:1] * axes
        + torch.linalg.cross(qe[..., None, 1:].expand_as(axes), axes, dim=-1))
    return err6, torch.cat([d_pos, d_ori], dim=-1).transpose(-1, -2)


def _mv(m: Tensor, v: Tensor) -> Tensor:
    """Matrix (..., n, m) times vector (..., m), with leading batch dims."""
    return m @ v if v.ndim == 1 else (m @ v.unsqueeze(-1)).squeeze(-1)


def _cast(tree, dtype):
    """The floating-point tensors of a tree of NamedTuples in ``dtype``."""
    if isinstance(tree, Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cast(x, dtype) for x in tree))
    return tree


def _solve_in(step, dtype):
    """The solver ``step`` computing in ``dtype``: the observation and the
    normals cast to it on the way in, the output back to the observation's
    dtype on the way out.  The solver state stays in ``dtype``."""

    def solve(state, obs, z=None):
        out, state = step(state, _cast(obs, dtype), None if z is None else z.to(dtype))
        return _cast(out, obs.base_target.dtype), state

    return solve


def make_whole_body_episode(
    params: "wbs.WholeBodyMPPIParams" = None,
    cfg: WholeBodyLoopConfig = WholeBodyLoopConfig(),
    n_control_steps: int = 300,
    low_k_guard: str = "warn",
    device="cuda",
    n_scenarios: Optional[int] = None,
    solver_dtype: Optional[torch.dtype] = None,
):
    """Returns ``run(plant, solver, ee_target, base_target, z=None) ->
    (carry, logs)`` with every :class:`WholeBodyLog` field stacked over the
    ``n_control_steps`` steps; the carry is ``(plant, solver, ee_target,
    base_target)``.  The solver is the plain pipeline.

    ``z`` (n_control_steps, K, H, A) optionally carries the solver's
    standard normals, one draw per control step, in place of the Philox
    stream.  ``n_scenarios=B``: B vehicles (see the module docstring);
    every argument's fields carry a leading B, ``z`` is (n_control_steps,
    B, K, H, A) and the logs come back (B, n_control_steps, ...).
    ``solver_dtype`` (default: the plant's) runs the solves in another
    dtype than the plant, cast at the solver's boundary; the solver state
    is then in that dtype."""
    params = params or wbs.WholeBodyMPPIParams()
    dev = resolve_device(device)
    mode = params.model.control_mode
    vehicle = params.model.vehicle
    extra = params.model.arm_mass_lump
    spec = params.model.chain()
    inertials = params.model.inertials()
    step, _ = wbs.make_whole_body_solver(params, device=dev, low_k_guard=low_k_guard,
                                         n_scenarios=n_scenarios)
    if solver_dtype is not None:
        step = _solve_in(step, solver_dtype)
    physics = PlantPhysics(
        vehicle=vehicle, spec=spec, dt=cfg.physics_dt, extra_mass=extra, mode=mode,
        arm_coeffs_per_control=cfg.arm_coeffs_per_control,
        mass_matrix_per_control=cfg.mass_matrix_per_control,
        inertials=inertials, model=params.model,
    )
    tube_radius = (cfg.tube_radius if cfg.tube_radius is not None
                   else (0.3 if mode == "position" else 0.08))
    tube_gain = (cfg.tube_gain if cfg.tube_gain is not None
                 else (1.5 if mode == "wrench" else 0.8))
    lookahead = min(cfg.setpoint_lookahead, params.mppi.n_horizon - 1)
    lead = () if n_scenarios is None else (int(n_scenarios),)

    def tube_servo(plant: WholeBodyPlant, ee_target: Pose, qdes: Tensor) -> Tensor:
        """Damped-least-squares arm servo on the measured EE pose residual,
        gated to act inside the tube radius."""
        err6, de_dq = pose_error_jacobian(spec, plant.q, plant.base.pos, plant.base.quat,
                                          ee_target, cfg.tube_ori_weight)
        d = torch.linalg.norm(err6[..., :3], dim=-1)
        gate = torch.sigmoid((tube_radius - d) / (0.25 * tube_radius))
        # Gauss-Newton/DLS step on ||err6||: de_dq dq = -err6.
        a = (de_dq @ de_dq.transpose(-1, -2)
             + cfg.tube_mu * torch.eye(6, dtype=err6.dtype, device=err6.device))
        dq = -_mv(de_dq.transpose(-1, -2), torch.linalg.solve_ex(a, err6).result)
        dq = dq.clamp(-cfg.tube_clip, cfg.tube_clip)
        return qdes + tube_gain * gate[..., None] * dq

    def control_step(carry, z: Optional[Tensor]):
        plant, solver, ee_target, base_target = carry
        state = observe(plant)
        out, solver = step(solver, wbs.WholeBodyObs(state=state, ee_target=ee_target,
                                                    base_target=base_target), z)
        qdes = out.qdes
        if tube_radius > 0.0 and tube_gain > 0.0:
            qdes = tube_servo(plant, ee_target, qdes)
        # Never command beyond the joint stops.
        qdes = torch.minimum(torch.maximum(qdes, device_const(spec.lower, qdes)),
                             device_const(spec.upper, qdes))

        # Arm torque: track the setpoint (the reference's phase-2 law).
        base_rot = rot.quat_to_matrix(plant.base.quat)
        if cfg.arm_coeffs_per_control:
            dyn = rb.frozen_arm_coeffs(spec, inertials, plant.q)
            m = dyn.mass
            nle = rb.frozen_nle(dyn, rb.gravity_accel(base_rot, plant.q.dtype), plant.qdot)
        else:
            m = rb.mass_matrix(spec, inertials, plant.q)
            nle = rb.nonlinear_effects(spec, inertials, plant.q, plant.qdot,
                                       base_rot=base_rot)
            dyn = torch.linalg.cholesky_ex(m).L if cfg.mass_matrix_per_control else None
        tau_arm = _mv(m, cfg.track_kp * (qdes - plant.q) - cfg.track_kd * plant.qdot) + nle
        effort = device_const(spec.effort, tau_arm)
        tau_arm = torch.minimum(torch.maximum(tau_arm, -effort), effort)

        if mode == "position":
            # Smooth carrot: the model's predicted position a short
            # lookahead along the updated plan.
            pred = _base_rollout_position(params.model, state, out.u_seq[..., None, :, :4],
                                          cfg.substeps * cfg.physics_dt)
            base_cmd = torch.cat([pred.pos[..., 0, lookahead, :], out.action[..., 3:4]], dim=-1)
        else:
            base_cmd = out.action[..., :4]

        for _ in range(cfg.substeps):
            plant = physics_tick(physics, plant, base_cmd, tau_arm, dyn)

        # One FK of the measured q and the commanded qdes together.
        pos2, quat2 = chain_mod.forward_kinematics_posquat(
            spec, torch.stack([plant.q, qdes]), base_pos=plant.base.pos,
            base_quat=plant.base.quat)
        d_pos = pos2 - ee_target.position
        qe = rot.quat_multiply(ee_target.quat, rot.quat_conjugate(quat2[0]))
        log = WholeBodyLog(
            ee_err=torch.linalg.norm(d_pos[0], dim=-1),
            base_pos=plant.base.pos,
            tilt=torch.linalg.norm(rpy_of(plant.base)[..., :2], dim=-1),
            l1_cmd=d_pos[1].abs().sum(dim=-1),
            l1_meas=d_pos[0].abs().sum(dim=-1),
            ori_err=2.0 * torch.arccos(qe[..., 0].abs().clamp(0.0, 1.0)),
        )
        return (plant, solver, ee_target, base_target), log

    def run(plant: WholeBodyPlant, solver, ee_target: Pose, base_target: Tensor,
            z: Optional[Tensor] = None):
        if z is not None:
            z = torch.as_tensor(z, dtype=torch.float32).to(dev)
            if z.shape[0] != n_control_steps:
                raise ValueError(f"z carries {z.shape[0]} steps, the episode {n_control_steps}")
        carry, logs = (plant, solver, ee_target, base_target), []
        for i in range(n_control_steps):
            carry, log = control_step(carry, None if z is None else z[i])
            logs.append(log)
        return carry, WholeBodyLog(*(torch.stack(f, dim=1 if lead else 0) for f in zip(*logs)))

    return run
