"""Arm (Kinova j2s7s300) MPPI preset: the reference's arm node solver.

Port of the JAX package's ``solver/arm.py``.  Joint-acceleration-sampled
MPPI drives the end effector to a target pose, with the arm hanging from
the (possibly moving) drone base: K=100 x H=32 x A=7 acceleration noise ->
kinematic double integration -> batched FK -> pose stage + terminal cost ->
softmin -> SavGol(9, 2) -> update.  It outputs the next (qdes, vdes)
setpoint integrated from the updated acceleration, with the reference's use
of the *previous* solve's first acceleration in the position update, kept
for parity.

The step is the plain pipeline (``solver/mppi.make_step``), on the card by
default, as the JAX preset runs XLA; with ``n_scenarios=B`` it solves B
problems per call, every state, observation and output field with a
leading B.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import chain as chain_mod
from ..models import kinova
from ..ops import costs as costs_mod
from ..ops import integrators, sampling
from ..utils.device import device_const, resolve_device
from ..utils.pose import Pose
from .mppi import MPPIConfig, MPPIState, init_state, make_step, scenario_lift

Tensor = torch.Tensor


class ArmObs(NamedTuple):
    """Per-solve inputs: the split of the reference node's 14-dim state."""

    q: Tensor          # (7,) arm joint positions; (B, 7) for a batch
    qdot: Tensor       # (7,) arm joint velocities
    base_pose: Pose    # floating-base world pose
    target: Pose       # end-effector target world pose


class ArmOutput(NamedTuple):
    qdes: Tensor           # (7,) next position setpoint
    vdes: Tensor           # (7,) next velocity setpoint
    u_seq: Tensor          # (H, 7) updated acceleration plan
    ee_target_err: Tensor  # () L1 position error of the commanded pose


@dataclass(frozen=True)
class ArmMPPIParams:
    mppi: MPPIConfig = field(default_factory=MPPIConfig)
    cost: costs_mod.ArmCostParams = field(default_factory=costs_mod.ArmCostParams)
    tip: str = "link_7"
    reach_threshold: float = 0.005


def default_target(dtype=torch.float32, device=None) -> Pose:
    """The reference's hardcoded demo target, its xyzw-stored quaternion
    read as the ROS layout it is."""
    return Pose.from_xyzw(
        torch.tensor([0.1029, 0.4055, 1.6498], dtype=dtype, device=device),
        torch.tensor([-0.5, -0.5, 0.5, -0.5], dtype=dtype, device=device),
    )


def make_arm_solver(
    params: ArmMPPIParams = ArmMPPIParams(),
    device="cuda",
    n_scenarios: Optional[int] = None,
    group=None,
    n_local_samples: Optional[int] = None,
):
    """Returns ``(step, init)``: ``step(state, obs, z=None) -> (ArmOutput,
    state)`` and ``init(seed, dtype=torch.float32) -> MPPIState`` on
    ``device``.  ``z`` optionally carries the step's standard normals
    (K, H, 7) in place of the Philox stream.  ``n_scenarios=B`` solves B
    problems per call (``init(seed)`` then takes one seed or B).

    Sample-sharded (``parallel/sharded.make_sharded_solver`` passes these):
    ``group`` is the ``torch.distributed`` group of the sample axis and
    ``n_local_samples`` this rank's share of ``n_samples``; each rank draws
    its shard of the Philox stream at its global sample offset, and ``z``
    is then this rank's (n_local_samples, H, 7) block."""
    dev = resolve_device(device)
    spec = kinova.chain(params.tip)
    cfg, cp = params.mppi, params.cost
    sigma_inv = np.linalg.inv(
        sampling.sigma_matrix(cfg.sigma, cfg.n_action, torch.float64).numpy())
    # Per-scenario observations meet the (B, K, H, ...) samples with a
    # sample axis (and for the per-step terms a step axis) inserted.
    lift = scenario_lift(n_scenarios)

    def rollout(v: Tensor, obs: ArmObs):
        q_samples, v_samples = integrators.double_integrate(v, lift(obs.q, 1),
                                                            lift(obs.qdot, 1), cfg.dt)
        ee_pos, ee_quat = chain_mod.forward_kinematics_posquat(
            spec, q_samples, base_pos=lift(obs.base_pose.position, 2),
            base_quat=lift(obs.base_pose.quat, 2))
        return q_samples, v_samples, ee_pos, ee_quat

    def cost(aux, v: Tensor, u_prev: Tensor, obs: ArmObs) -> Tensor:
        q_samples, _, ee_pos, ee_quat = aux
        tpos, tquat = obs.target.position, obs.target.quat
        s = costs_mod.pose_stage_cost_pq(ee_pos, ee_quat, lift(tpos, 2), lift(tquat, 2),
                                         cp.stage_pose_weight, cp.stage_orientation_weight,
                                         cp.ori_mode)
        s = s + costs_mod.pose_terminal_cost_pq(ee_pos, ee_quat, lift(tpos, 1),
                                                lift(tquat, 1), cp.terminal_pose_weight,
                                                cp.terminal_orientation_weight, cp.ori_mode)
        if cp.covar_weight:
            s = s + costs_mod.covariance_cost(u_prev, v, device_const(sigma_inv, v),
                                              cp.covar_weight, cfg.lam, cp.alpha)
        if cp.action_weight:
            s = s + costs_mod.action_cost(v, cp.action_weight, cp.gamma)
        if cp.centering_weight:
            s = s + costs_mod.centering_cost(q_samples, device_const(kinova.Q_CENTER, v),
                                             cp.centering_weight, cp.gamma)
        if cp.joint_limit_weight:
            s = s + cp.joint_limit_weight * costs_mod.joint_limit_cost(
                q_samples, device_const(spec.lower, v), device_const(spec.upper, v), cp.gamma)
        return s

    inner = make_step(cfg, rollout, cost, group=group, n_local_samples=n_local_samples,
                      n_scenarios=n_scenarios)

    def step(state: MPPIState, obs: ArmObs, z=None) -> Tuple[ArmOutput, MPPIState]:
        # The reference reads the previous plan's first acceleration before
        # the update and integrates qdes with it: kept bit for bit.
        qddot_prev = state.u_prev[..., 0, :]
        u_seq, new_state = inner(state, obs, z)
        u0 = u_seq[..., 0, :]
        vdes = obs.qdot + u0 * cfg.dt
        qdes = obs.q + qddot_prev * cfg.dt + 0.5 * u0 * cfg.dt * cfg.dt
        ee_cmd, _ = chain_mod.forward_kinematics_posquat(
            spec, qdes, base_pos=obs.base_pose.position, base_quat=obs.base_pose.quat)
        err = torch.sum(torch.abs(ee_cmd - obs.target.position), dim=-1)
        return ArmOutput(qdes=qdes, vdes=vdes, u_seq=u_seq, ee_target_err=err), new_state

    def init(seed, dtype=torch.float32) -> MPPIState:
        return init_state(cfg, seed, dtype, dev, n_scenarios)

    return step, init


def reached(output: ArmOutput, params: ArmMPPIParams = ArmMPPIParams()) -> Tensor:
    """The reference's reach check: L1 position error of the commanded EE
    pose below 5 mm."""
    return output.ee_target_err < params.reach_threshold
