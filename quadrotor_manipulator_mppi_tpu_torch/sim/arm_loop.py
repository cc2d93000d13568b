"""Arm control node: the reference's ``kinova.py`` loop.

Port of the JAX package's ``sim/arm_loop.py``: a 100 Hz two-phase torque
controller for the base-fixed Kinova arm,

* **phase 1**: cubic joint trajectory to the home posture with the
  computed-torque PD ``tau = M (1000 e - 100 qdot) + g`` over 1.5 s; hand
  over to MPPI once ``|q - q_home| < 0.01`` has held for 50 ticks;
* **phase 2**: MPPI position setpoints tracked with the inertia-weighted PD
  ``tau = M (400 (qdes - q) - 40 qdot) + g``.

M(q) and the nonlinear effects come from ``models/rigid_body``; the plant
is the arm's own forward dynamics under the base's gravity direction,
integrated semi-implicitly at 1 kHz.  The phase logic is arithmetic
masking, with no data-dependent Python branch: the solve runs every step,
and during phase 1 ``torch.where`` keeps every field of the old solver
state, the solve index included, so the Philox stream does not advance
before the handover.

On the card the episode captures one control step in a CUDA graph
(``utils/graphs``) and replays it once per step, as the whole-body and
drone episodes do; ``graph=False``, and the CPU, run it eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..models import kinova
from ..models import rigid_body as rb
from ..solver import arm as arm_solver
from ..solver.mppi import MPPIState, device_counters
from ..utils import graphs, trajectory
from ..utils import rotations as rot
from ..utils.device import device_const, resolve_device
from ..utils.pose import Pose

Tensor = torch.Tensor


@dataclass(frozen=True)
class ArmLoopConfig:
    control_dt: float = 0.01      # 100 Hz
    substeps: int = 10            # 1 kHz plant integration
    home_duration: float = 1.5
    home_kp: float = 1000.0
    home_kd: float = 100.0
    track_kp: float = 400.0
    track_kd: float = 40.0
    converge_tol: float = 0.01
    converge_ticks: int = 50
    torque_limit_scale: float = 1.0  # 1.0 enforces the URDF effort limits


class ArmLoopState(NamedTuple):
    q: Tensor            # (7,) plant joint positions
    qdot: Tensor         # (7,)
    t: Tensor            # () sim time
    phase2: Tensor       # () bool: MPPI engaged
    hold_count: Tensor   # () int32 convergence counter
    q_start: Tensor      # (7,) phase-1 trajectory start
    t_start: Tensor      # () phase-1 start time
    solver: MPPIState


def init_arm_loop(solver_state: MPPIState, q0=None, dtype=torch.float32,
                  device="cuda") -> ArmLoopState:
    """Rest at ``q0`` (default: zeros) in phase 1 at t = 0."""
    dev = resolve_device(device)
    q = torch.zeros(7, dtype=dtype, device=dev) if q0 is None else \
        torch.as_tensor(q0, dtype=dtype).to(dev)
    return ArmLoopState(
        q=q, qdot=torch.zeros(7, dtype=dtype, device=dev),
        t=torch.zeros((), dtype=dtype, device=dev),
        phase2=torch.zeros((), dtype=torch.bool, device=dev),
        hold_count=torch.zeros((), dtype=torch.int32, device=dev),
        q_start=q.clone(), t_start=torch.zeros((), dtype=dtype, device=dev),
        solver=solver_state,
    )


def make_arm_episode(
    cfg: ArmLoopConfig = ArmLoopConfig(),
    params: arm_solver.ArmMPPIParams = arm_solver.ArmMPPIParams(),
    base_pose: Optional[Pose] = None,
    target: Optional[Pose] = None,
    n_control_steps: int = 500,
    device="cuda",
    graph: bool = True,
):
    """Build ``run(state, z=None) -> (final, (q, ee_err, tau))``, each log
    stacked over the control steps.  ``z`` (n_control_steps, K, H, 7)
    optionally carries the solver's standard normals of each step in place
    of the Philox stream.  The final state's solver carries its seed and
    solve index as int64 tensors.  On the card (``graph=True``) the first
    call captures one control step in a CUDA graph and every call replays
    it; the returned state and logs are copies."""
    dev = resolve_device(device)
    spec = kinova.chain(params.tip)
    inertials = kinova.inertials()
    solver_step, _ = arm_solver.make_arm_solver(params, device=dev)
    if base_pose is None:
        base_pose = Pose(position=torch.tensor([0.0, 0.0, 2.1], device=dev),
                         quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev))
    target = target if target is not None else arm_solver.default_target(device=dev)
    base_rot = rot.quat_to_matrix(base_pose.quat)
    sub_dt = cfg.control_dt / cfg.substeps

    def control_step(state: ArmLoopState, z: Optional[Tensor]):
        q_home = device_const(kinova.Q_HOME, state.q)
        effort = device_const(spec.effort, state.q) * cfg.torque_limit_scale
        m = rb.mass_matrix(spec, inertials, state.q)
        nle = rb.nonlinear_effects(spec, inertials, state.q, state.qdot, base_rot=base_rot)

        # Phase 1: cubic home trajectory + computed-torque PD.
        qdes1 = trajectory.joint_trajectory(state.t, state.t_start, cfg.home_duration,
                                            state.q_start, q_home)
        tau1 = m @ (cfg.home_kp * (qdes1 - state.q) - cfg.home_kd * state.qdot) + nle

        # Phase 2: MPPI setpoint + inertia-weighted PD.
        obs = arm_solver.ArmObs(q=state.q, qdot=state.qdot, base_pose=base_pose,
                                target=target)
        out, solver = solver_step(state.solver, obs, z)
        tau2 = m @ (cfg.track_kp * (out.qdes - state.q) - cfg.track_kd * state.qdot) + nle

        phase2 = state.phase2
        tau = torch.where(phase2, tau2, tau1)
        tau = torch.minimum(torch.maximum(tau, -effort), effort)
        # The warm start and the solve index advance only once MPPI is engaged.
        solver = MPPIState(*(torch.where(phase2, new, old)
                             for new, old in zip(solver, state.solver)))

        q, qdot = state.q, state.qdot
        for _ in range(cfg.substeps):
            qdd = rb.forward_dynamics(spec, inertials, q, qdot, tau, base_rot=base_rot)
            qdot = qdot + qdd * sub_dt
            q = q + qdot * sub_dt

        # Convergence gate: hand over after converge_ticks near home.
        near = torch.linalg.norm(q_home - q) < cfg.converge_tol
        hold = torch.where(near, state.hold_count + 1, torch.zeros_like(state.hold_count))
        phase2 = phase2 | (hold > cfg.converge_ticks)
        nxt = ArmLoopState(q=q, qdot=qdot, t=state.t + cfg.control_dt, phase2=phase2,
                           hold_count=hold, q_start=state.q_start, t_start=state.t_start,
                           solver=solver)
        return nxt, (q, out.ee_target_err, tau)

    episode = graphs.episode_runner(control_step, lambda s: (s.q, s.t, s.q), n_control_steps,
                                    dev, graph)

    def run(state: ArmLoopState, z: Optional[Tensor] = None):
        if z is not None:
            z = torch.as_tensor(z, dtype=state.q.dtype).to(dev)
        # Tensor counters, so the phase mask can keep the old solve index.
        return episode(state._replace(solver=device_counters(state.solver, dev)), z)

    return run
