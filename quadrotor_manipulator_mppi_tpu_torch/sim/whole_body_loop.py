"""Whole-body closed loop: MPPI base + arm actions driving the full plant.

Port of the JAX package's ``sim/whole_body_loop.py``.  Every 10 ms control
step solves the whole-body MPPI problem, servos the arm setpoint onto the
measured end-effector pose error, turns it into joint torques with the
reference's inertia-weighted tracking law, and runs ``substeps`` 1 kHz
physics steps of the full plant: the quaternion octorotor with rotor lag
(``models/multirotor``), the arm's forward dynamics under the tilted
gravity field (``models/rigid_body``), the arm gravity moment acting back on
the base, and the base controller of the mode (attitude PD, position
backstepping or direct wrench).

In the serving configuration (position mode, ``arm_coeffs_per_control``,
``plant_kernel``) the control period's physics is ONE launch of the CUDA
plant-tick kernel (``ops/cuda/plant_kernel``).

Where the JAX package scans, the episode here captures one control step in
a CUDA graph (``utils/graphs.graphed``) and replays it once per step:
the plant, the solver state and the targets are updated in place in static
buffers, the solve index advances on the card, and each step writes its
log row into preallocated (n_control_steps, ...) buffers at a device step
index.  The eager loop (``graph=False``, and always on the CPU) runs the
same control step and never waits for the card either.

With ``n_scenarios=B`` the episode runs B vehicles at once, as
``jax.vmap`` of the JAX episode does (the fleet of the
``whole-body-batch`` scenario): every field of the plant, the solver state
and the targets with a leading B, one batched solve and one B-row plant
tick per control step, the logs (B, n_control_steps).  :func:`fleet_starts`
draws the fleet's randomized starts.

The pick_weight task's branches: a grasped payload (``payload_mass``: link
7's mass and centre of mass carry it, in the per-substep RNEA plant and in
the plant tick's frozen coefficients alike), the free-body graspable object
(``sim/graspable``: the carry gains its state, the palm's push reaction
acts back on the vehicle and the arm), and the primitive contact layer
(``sim/contact``).  Both feed the external body wrench of the base's
physics step.  The end effector's velocity and position Jacobian are the
closed-form ones of the joint frames, where the JAX package differentiates
its forward kinematics.
"""

from __future__ import annotations

import dataclasses
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
from ..solver.mppi import device_counters
from ..utils import graphs, profiling
from ..utils import rotations as rot
from ..utils.device import device_const, resolve_device
from ..utils.pose import Pose
from . import closed_loop as cl
from . import contact as ct
from . import flight_control as fc
from . import graspable as gr

Tensor = torch.Tensor


@dataclass(frozen=True)
class WholeBodyLoopConfig:
    """The JAX package's loop configuration, field for field (see there for
    the measurements behind each default)."""

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
    payload_mass: float = 0.0
    plant_arm_lump: Optional[float] = None
    mass_matrix_per_control: bool = False
    arm_coeffs_per_control: bool = False
    substep_unroll: int = 1               # XLA scan unrolling; no effect here
    plant_kernel: bool = False


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
    obj_pos: Tensor   # (3,) graspable-object position (zeros without one)


_VECTOR_LOGS = ("base_pos", "obj_pos")  # the (3,) fields of a WholeBodyLog row


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


def fleet_starts(params: "wbs.WholeBodyMPPIParams", n_scenarios: int, seed: int = 0,
                 device="cuda"):
    """The randomized starts of an ``n_scenarios`` fleet, as the JAX
    package's ``whole-body-batch`` scenario draws them: each base starts
    within +-0.3 m of the hover point (0, 0, 2.1), each EE target lies
    within +-0.15 m of the default target, and each base station is
    re-centred over its goal by the same offset.  The offsets come from a
    NumPy generator seeded with ``seed`` (the distribution is the JAX
    scenario's; the draws are not), the solver keys from
    ``parallel.sharded.scenario_seeds(seed, n_scenarios)``.

    Returns ``(plants, solver_state, ee_targets, base_targets)``, each
    field with a leading ``n_scenarios``: ``run``'s arguments."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base_off = rng.uniform(-0.3, 0.3, (n_scenarios, 3))
    tgt_off = torch.as_tensor(rng.uniform(-0.15, 0.15, (n_scenarios, 3)),
                              dtype=torch.float32).to(dev)
    obs = wbs.default_obs(device=dev)
    plants = init_plant(params.model.vehicle, pos=np.asarray([0.0, 0.0, 2.1]) + base_off,
                        device=dev)
    _, init = wbs.make_whole_body_solver(params, device=dev, low_k_guard="off",
                                         n_scenarios=n_scenarios)
    targets = Pose(position=obs.ee_target.position + tgt_off,
                   quat=obs.ee_target.quat.expand(n_scenarios, 4).clone())
    return plants, init(seed), targets, obs.base_target + tgt_off


def observe(plant: WholeBodyPlant) -> WholeBodyState:
    """Full plant -> the solver's reduced observation."""
    base12 = Multirotor12State(pos=plant.base.pos, rpy=cl.rpy_of(plant.base),
                               vel=plant.base.vel, omega=plant.base.omega)
    return WholeBodyState(base=base12, q=plant.q, qdot=plant.qdot)


def payload_inertials(inertials: InertialParams, payload_mass: float) -> InertialParams:
    """Link 7 carrying a point mass at its frame origin (the end-effector
    tip frame is the link-7 frame): the combined mass, and the centre of
    mass moved toward the origin.  The point mass adds no inertia about
    itself; the shift of the centre of mass carries the moment."""
    if payload_mass <= 0.0:
        return inertials
    mass, com = inertials.mass.copy(), inertials.com.copy()
    m7 = mass[-1]
    com[-1] = com[-1] * (m7 / (m7 + payload_mass))
    mass[-1] = m7 + payload_mass
    return dataclasses.replace(inertials, mass=mass, com=com)


def physics_tick(ph: PlantPhysics, plant: WholeBodyPlant, action_cmd: Tensor,
                 tau_arm_pd: Tensor, dyn, ext_wrench_b=None) -> WholeBodyPlant:
    """One 1 kHz physics step (batched over leading dims).  ``dyn`` is the
    control step's FrozenArmCoeffs (``arm_coeffs_per_control``), the
    Cholesky factor of M (``mass_matrix_per_control``) or unused;
    ``ext_wrench_b`` an external (force, torque) on the base, body frame,
    held over the control period (contact and the object's reaction)."""
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
        tau = inertia * (kp * (action_cmd[..., 1:4] - cl.rpy_of(plant.base))
                         - kd * plant.base.omega) - tau_g
        wrench_cmd = torch.cat([action_cmd[..., 0:1], tau], dim=-1)
    elif ph.mode == "position":
        # Backstepping inner loop tracks the position setpoint.
        zeros = torch.zeros_like(action_cmd[..., 0:3])
        sp = fc.FlightSetpoint(pos=action_cmd[..., 0:3], vel=zeros, yaw=action_cmd[..., 3],
                               yaw_rate=zeros[..., 0])
        wrench_cmd, ctrl = fc.backstepping_step(
            ph.gains, ph.vehicle, ctrl, sp, pos=plant.base.pos, vel_world=plant.base.vel,
            rpy=cl.rpy_of(plant.base), omega_body=plant.base.omega, dt=dt, tau_g=tau_g,
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

    ext = ((torch.zeros_like(tau_g), tau_g) if ext_wrench_b is None
           else (ext_wrench_b[0], tau_g + ext_wrench_b[1]))
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


def ee_motion(spec: ChainSpec, plant: WholeBodyPlant):
    """The end effector's world position (..., 3), velocity (..., 3) and
    position Jacobian in q (..., 3, J) at the plant's state: the tangent the
    JAX package takes with ``jax.jvp`` of its forward kinematics (the base
    quaternion moving at 0.5 q (0, omega)) and its ``jax.jacfwd``."""
    base = plant.base
    origins, axes, ee, _ = chain_mod.joint_frames_posquat(spec, plant.q, base.pos, base.quat)
    omega_w = (rot.quat_to_matrix(base.quat) @ base.omega.unsqueeze(-1)).squeeze(-1)
    vel, jac = ct.point_motion(origins, axes, ee[..., None, :], plant.qdot, base.pos,
                               base.vel, omega_w, device_const([[1.0] * spec.n_joints], ee))
    return ee, vel[..., 0, :], jac[..., 0, :, :]


def _mv(m: Tensor, v: Tensor) -> Tensor:
    """Matrix (..., n, m) times vector (..., m), with leading batch dims."""
    return m @ v if v.ndim == 1 else (m @ v.unsqueeze(-1)).squeeze(-1)


def make_whole_body_episode(
    params: "wbs.WholeBodyMPPIParams" = None,
    cfg: WholeBodyLoopConfig = WholeBodyLoopConfig(),
    n_control_steps: int = 300,
    graspable: Optional[gr.GraspableParams] = None,
    gripper_closed: bool = False,
    backend: str = "cuda",
    contact: Optional[ct.ContactParams] = None,
    low_k_guard: str = "warn",
    device="cuda",
    n_scenarios: Optional[int] = None,
    graph: bool = True,
):
    """Returns ``run(plant, solver, ee_target, base_target, obj=None,
    z=None) -> (carry, logs)`` with every :class:`WholeBodyLog` field
    stacked over the ``n_control_steps`` steps; the carry is ``(plant,
    solver, ee_target, base_target)``, and with ``graspable`` also ``obj``.

    ``graspable`` (a ``sim.graspable.GraspableParams``) simulates the
    pick_weight object as a free body: ``run`` then takes its
    ``GraspableState`` as ``obj``, the palm can push it off its stand, and
    the push reaction acts back on the vehicle and the arm.
    ``gripper_closed`` is the episode's gripper command.  ``contact`` (a
    ``sim.contact.ContactParams``) lets the hull and arm-link spheres feel
    the world geometry.  ``cfg.payload_mass`` puts a grasped mass on link 7
    of the plant (``cfg.plant_arm_lump`` the lump the plant's base carries
    beside it).

    ``z`` (n_control_steps, K, H, A) optionally carries the solver's
    standard normals, one draw per control step, in place of the Philox
    stream.  ``backend`` selects the solver pipeline (``"cuda"``, the
    kernels; ``"torch"``, the plain pipeline, on any device).

    ``n_scenarios=B``: B vehicles, as ``jax.vmap(run)`` of the JAX episode
    (see the module docstring); every argument's fields carry a leading B,
    ``z`` is (n_control_steps, B, K, H, A) and the logs come back
    (B, n_control_steps, ...).

    On the card (``graph=True``) the first call captures one control step
    in a CUDA graph and every call replays it ``n_control_steps`` times
    (arguments of other shapes get a graph of their own); the object's
    state is one of the graph's buffers.  The returned carry and logs are
    copies.  The solver state comes back with its seed and solve index as
    int64 device tensors.  ``graph=False`` runs the control steps eagerly;
    so does the CPU."""
    params = params or wbs.WholeBodyMPPIParams()
    dev = resolve_device(device)
    mode = params.model.control_mode
    if cfg.plant_kernel and not (mode == "position" and cfg.arm_coeffs_per_control
                                 and graspable is None and contact is None):
        raise ValueError(
            "plant_kernel covers the serving configuration only: "
            "position mode + arm_coeffs_per_control, free flight"
        )
    vehicle = params.model.vehicle
    extra = (cfg.plant_arm_lump if cfg.plant_arm_lump is not None
             else params.model.arm_mass_lump) + cfg.payload_mass
    spec = params.model.chain()
    inertials = payload_inertials(params.model.inertials(), cfg.payload_mass)
    step, _ = wbs.make_whole_body_solver(params, device=dev, backend=backend,
                                         low_k_guard=low_k_guard, n_scenarios=n_scenarios)
    physics = PlantPhysics(
        vehicle=vehicle, spec=spec, dt=cfg.physics_dt, extra_mass=extra, mode=mode,
        arm_coeffs_per_control=cfg.arm_coeffs_per_control,
        mass_matrix_per_control=cfg.mass_matrix_per_control,
        inertials=inertials, model=params.model,
    )
    if cfg.plant_kernel:
        from ..ops.cuda import plant_kernel as pk

        plant_tick = pk.make_plant_tick_kernel(
            vehicle, fc.FlightGains(), spec, substeps=cfg.substeps, dt=cfg.physics_dt,
            extra_mass=extra, device=dev,
        )
    tube_radius = (cfg.tube_radius if cfg.tube_radius is not None
                   else (0.3 if mode == "position" else 0.08))
    tube_gain = (cfg.tube_gain if cfg.tube_gain is not None
                 else (1.5 if mode == "wrench" else 0.8))
    lookahead = min(cfg.setpoint_lookahead, params.mppi.n_horizon - 1)
    lead = () if n_scenarios is None else (int(n_scenarios),)
    external = graspable is not None or contact is not None

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

    def external_wrench(plant: WholeBodyPlant, obj, tau_arm: Tensor, effort: Tensor):
        """The contact layer's and the object's forces over this control
        period: (base wrench, body frame), the arm torque with their joint
        torques added, and the object's new state."""
        zeros = torch.zeros_like(plant.base.pos)
        ext_f, ext_tau = zeros, zeros
        if contact is not None:
            f_cb, tau_cb, tau_carm = ct.whole_body_contact(
                contact, spec, plant.q, plant.qdot, plant.base.pos, plant.base.quat,
                plant.base.vel, plant.base.omega)
            ext_f, ext_tau = ext_f + f_cb, ext_tau + tau_cb
            tau_arm = torch.minimum(torch.maximum(tau_arm + tau_carm, -effort), effort)
        if graspable is not None:
            # Step the object over this period with the palm's pose and
            # velocity; its push reaction acts on the vehicle and the arm.
            ee_pos, ee_vel, j_ee = ee_motion(spec, plant)
            obj, reaction_w = gr.graspable_step(graspable, obj, ee_pos, ee_vel, gripper_closed,
                                                cfg.substeps * cfg.physics_dt)
            r_t = rot.quat_to_matrix(plant.base.quat).transpose(-1, -2)
            ext_f = ext_f + _mv(r_t, reaction_w)
            ext_tau = ext_tau + _mv(r_t, torch.linalg.cross(ee_pos - plant.base.pos,
                                                            reaction_w, dim=-1))
            tau_arm = torch.minimum(torch.maximum(
                tau_arm + _mv(j_ee.transpose(-1, -2), reaction_w), -effort), effort)
        return (ext_f, ext_tau), tau_arm, obj

    def control_step(carry, z: Optional[Tensor]):
        plant, solver, ee_target, base_target = carry[:4]
        obj = carry[4] if graspable is not None else None
        # The stage marks (utils.profiling) name the step's parts, inside a
        # captured step too; each part runs from its mark to the next.
        profiling.mark("wb_loop.solve")
        state = observe(plant)
        out, solver = step(solver, wbs.WholeBodyObs(state=state, ee_target=ee_target,
                                                    base_target=base_target), z)

        profiling.mark("wb_loop.servo")
        qdes = out.qdes
        if tube_radius > 0.0 and tube_gain > 0.0:
            qdes = tube_servo(plant, ee_target, qdes)
        # Never command beyond the joint stops.
        qdes = torch.minimum(torch.maximum(qdes, device_const(spec.lower, qdes)),
                             device_const(spec.upper, qdes))

        profiling.mark("wb_loop.arm_dynamics")
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

        profiling.mark("wb_loop.carrot")
        if mode == "position":
            # Smooth carrot: the model's predicted position a short
            # lookahead along the updated plan.
            pred = _base_rollout_position(params.model, state,
                                          out.u_seq[..., None, :, :4],
                                          cfg.substeps * cfg.physics_dt)
            base_cmd = torch.cat([pred.pos[..., 0, lookahead, :], out.action[..., 3:4]],
                                 dim=-1)
        else:
            base_cmd = out.action[..., :4]

        ext_wrench_b = None
        if external:
            profiling.mark("wb_loop.contact")
            ext_wrench_b, tau_arm, obj = external_wrench(plant, obj, tau_arm, effort)

        profiling.mark("wb_loop.tick")
        if cfg.plant_kernel:
            plant = pk.unpack_plant(plant_tick(pk.pack_plant(plant), pk.pack_dyn(dyn),
                                               base_cmd, tau_arm))
        else:
            for _ in range(cfg.substeps):
                plant = physics_tick(physics, plant, base_cmd, tau_arm, dyn, ext_wrench_b)

        profiling.mark("wb_loop.logs")
        # One FK of the measured q and the commanded qdes together.
        pos2, quat2 = chain_mod.forward_kinematics_posquat(
            spec, torch.stack([plant.q, qdes]), base_pos=plant.base.pos,
            base_quat=plant.base.quat)
        d_pos = pos2 - ee_target.position
        qe = rot.quat_multiply(ee_target.quat, rot.quat_conjugate(quat2[0]))
        log = WholeBodyLog(
            ee_err=torch.linalg.norm(d_pos[0], dim=-1),
            base_pos=plant.base.pos,
            tilt=torch.linalg.norm(cl.rpy_of(plant.base)[..., :2], dim=-1),
            l1_cmd=d_pos[1].abs().sum(dim=-1),
            l1_meas=d_pos[0].abs().sum(dim=-1),
            ori_err=2.0 * torch.arccos(qe[..., 0].abs().clamp(0.0, 1.0)),
            obj_pos=obj.pos if graspable is not None else torch.zeros_like(plant.base.pos),
        )
        new_carry = (plant, solver, ee_target, base_target)
        return (new_carry + (obj,) if graspable is not None else new_carry), log

    def check_z(z):
        if z is None:
            return None
        z = torch.as_tensor(z, dtype=torch.float32).to(dev)
        if z.shape[0] != n_control_steps:
            raise ValueError(f"z carries {z.shape[0]} steps, the episode {n_control_steps}")
        return z

    def run_eager(carry, z):
        logs = []
        for i in range(n_control_steps):
            carry, log = control_step(carry, None if z is None else z[i])
            logs.append(log)
        return carry, WholeBodyLog(*(torch.stack(f, dim=1 if lead else 0) for f in zip(*logs)))

    load = graphs.graphed(graphs.episode_step(control_step), dev) if dev.type == "cuda" \
        else None

    def run_graphed(carry, z):
        # The solver state with its key and solve index as device tensors.
        carry = (carry[0], device_counters(carry[1], dev)) + tuple(carry[2:])
        logs = WholeBodyLog(**{
            f: torch.zeros((n_control_steps,) + lead + ((3,) if f in _VECTOR_LOGS else ()),
                           dtype=carry[0].base.pos.dtype, device=dev)
            for f in WholeBodyLog._fields})
        carry, logs = graphs.run_episode(load, carry, z, logs, n_control_steps)
        return carry, WholeBodyLog(*(buf.movedim(0, 1) if lead else buf for buf in logs))

    def run(plant: WholeBodyPlant, solver, ee_target: Pose, base_target: Tensor,
            obj: Optional[gr.GraspableState] = None, z: Optional[Tensor] = None):
        if (obj is None) != (graspable is None):
            raise ValueError("run takes the object's state exactly when the episode has "
                             "a graspable object")
        carry = (plant, solver, ee_target, base_target) + ((obj,) if obj is not None else ())
        z = check_z(z)
        if graph and load is not None:
            return run_graphed(carry, z)
        return run_eager(carry, z)

    return run
