"""Whole-body quadrotor + arm MPPI — the flagship solver configuration.

Port of the JAX package's ``solver/whole_body.py``: 4 base + 7 arm actions
over the coupled rollout (``models/whole_body.rollout``), with an
end-effector pose cost plus base regularization.  Flagship point: K=4096,
H=50, attitude mode.

``make_whole_body_solver`` builds the solve on the plain pipeline
(``solver/mppi.make_step``), the port's ``backend="torch"`` and the
counterpart of the JAX package's XLA backend, on any device.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import chain as chain_mod
from ..models import kinova
from ..models.multirotor import Multirotor12State
from ..models.whole_body import (
    N_BASE_ACTIONS,
    WholeBodyParams,
    WholeBodyState,
    _quat_from_rpy,
    hover_nominal_action,
    rollout,
)
from ..ops import costs as costs_mod
from ..utils.device import device_const, resolve_device
from ..utils.pose import Pose
from .mppi import MPPIConfig, MPPIState, _diag_sigma, make_step, scenario_state

Tensor = torch.Tensor

N_ACTIONS = N_BASE_ACTIONS + kinova.N_JOINTS  # 11


def default_sigma() -> np.ndarray:
    """Attitude-mode exploration scales: [thrust N, roll/pitch/yaw rad,
    qddot x7]."""
    return np.asarray([8.0, 0.08, 0.08, 0.05] + [1.0] * kinova.N_JOINTS)


def wrench_sigma() -> np.ndarray:
    """Direct-wrench exploration scales: [thrust N, torque N*m x3, qddot x7]."""
    return np.asarray([30.0, 3.0, 3.0, 1.0] + [1.0] * kinova.N_JOINTS)


@dataclass(frozen=True)
class WholeBodyCostParams:
    stage_pose_weight: float = 50.0
    stage_orientation_weight: float = 30.0
    terminal_pose_weight: float = 40.0
    terminal_orientation_weight: float = 30.0
    base_pos_weight: float = 100.0
    attitude_weight: float = 200.0
    omega_weight: float = 5.0
    vel_weight: float = 40.0
    action_weight: float = 0.0
    joint_limit_weight: float = 1.0
    joint_limit_soft: bool = True
    gamma: float = 0.98
    ori_mode: str = "log"
    obstacle_weight: float = 0.0
    obstacle_centers: tuple = ()        # ((x, y, z), ...)
    obstacle_radii: tuple = ()
    # Terminal stopping-point cost on the base: |p_H + T_stop v_H - p*|^2.
    stop_weight: float = 1200.0
    stop_horizon: float = 1.2


def default_nominal_action() -> np.ndarray:
    """Hover nominal: gravity-balancing thrust, level, zero accelerations."""
    nominal = np.zeros(N_ACTIONS)
    p = WholeBodyParams()
    nominal[0] = (p.vehicle.mass + p.arm_mass_lump) * 9.81
    return nominal


def default_action_bounds():
    """Attitude-mode clamps: thrust [0, 400] N, tilt +-0.35 rad, yaw +-0.6,
    joint accel +-20 rad/s^2."""
    lo = np.asarray([0.0, -0.35, -0.35, -0.6] + [-20.0] * kinova.N_JOINTS)
    hi = np.asarray([400.0, 0.35, 0.35, 0.6] + [20.0] * kinova.N_JOINTS)
    return lo, hi


_SCHEDULE_CHAIN = kinova.chain("link_7")


def ee_error_sigma_schedule(
    r0: float = 0.25, floor: float = 0.02, base_floor: Optional[float] = None,
):
    """Scale sigma by the current end-effector distance-to-go,
    ``clip(|p_ee - p*| / r0, floor, 1)``; ``base_floor`` sets a separate
    floor for the 4 base channels.  One 7-joint FK per solve; for an
    observation with a leading scenario axis B the scale is (B, 1) or
    (B, A), one FK per scenario in one batched pass."""

    def scale(obs: "WholeBodyObs") -> Tensor:
        bq = _quat_from_rpy(obs.state.base.rpy)
        ee_pos, _ = chain_mod.forward_kinematics_posquat(
            _SCHEDULE_CHAIN, obs.state.q, base_pos=obs.state.base.pos, base_quat=bq
        )
        d = torch.linalg.norm(ee_pos - obs.ee_target.position, dim=-1)
        s_arm = torch.clamp(d / r0, floor, 1.0)[..., None]
        if base_floor is None:
            return s_arm if d.ndim else s_arm[0]
        s_base = torch.clamp(d / r0, base_floor, 1.0)[..., None]
        return torch.cat([s_base.expand(*d.shape, N_BASE_ACTIONS),
                          s_arm.expand(*d.shape, kinova.N_JOINTS)], dim=-1)

    # Declarative identity, so the configuration tree round-trips.
    scale.__qmm_schedule__ = {
        "kind": "ee_error", "r0": r0, "floor": floor,
        **({} if base_floor is None else {"base_floor": base_floor}),
    }
    return scale


def position_mode_params(n_samples: int = 4096, n_horizon: int = 50) -> "WholeBodyMPPIParams":
    """Position-cascade mode: [base setpoint offsets xyz, yaw, qddot x7]."""
    sigma = np.asarray([0.25, 0.25, 0.25, 0.1] + [2.0] * kinova.N_JOINTS)
    lo = np.asarray([-1.5, -1.5, -1.0, -0.6] + [-20.0] * kinova.N_JOINTS)
    hi = np.asarray([1.5, 1.5, 1.0, 0.6] + [20.0] * kinova.N_JOINTS)
    return WholeBodyMPPIParams(
        mppi=MPPIConfig(
            n_samples=n_samples, n_horizon=n_horizon, n_action=N_ACTIONS,
            dt=0.01, lam=0.1, sigma=sigma, savgol_window=9, u_min=lo, u_max=hi,
            warm_start_decay=0.9, nominal_action=np.zeros(N_ACTIONS),
            sigma_scale_fn=ee_error_sigma_schedule(),
        ),
        model=WholeBodyParams(control_mode="position"),
        cost=WholeBodyCostParams(
            base_pos_weight=50.0, attitude_weight=100.0,
            omega_weight=1.0, vel_weight=10.0, stop_weight=0.0,
        ),
    )


def wrench_mode_params(n_samples: int = 4096, n_horizon: int = 50) -> "WholeBodyMPPIParams":
    """Direct-wrench mode with its stabilizers: rate damping, the terminal
    stop cost and a separate near-convergence base sigma floor."""
    sigma = np.asarray([8.0, 1.2, 1.2, 0.5] + [1.0] * kinova.N_JOINTS)
    lo = np.asarray([0.0, -6.0, -6.0, -3.0] + [-20.0] * kinova.N_JOINTS)
    hi = np.asarray([400.0, 6.0, 6.0, 3.0] + [20.0] * kinova.N_JOINTS)
    return WholeBodyMPPIParams(
        mppi=MPPIConfig(
            n_samples=n_samples, n_horizon=n_horizon, n_action=N_ACTIONS,
            dt=0.01, lam=0.1, sigma=sigma, savgol_window=9, u_min=lo, u_max=hi,
            warm_start_decay=0.9, nominal_action=default_nominal_action(),
            sigma_scale_fn=ee_error_sigma_schedule(base_floor=0.005),
        ),
        model=WholeBodyParams(
            control_mode="wrench", rate_damping=12.0, couple_arm_gravity=False,
        ),
        cost=WholeBodyCostParams(
            base_pos_weight=800.0, vel_weight=600.0,
            attitude_weight=400.0, omega_weight=10.0,
            stop_weight=8000.0, stop_horizon=1.2,
        ),
    )


@dataclass(frozen=True)
class WholeBodyMPPIParams:
    mppi: MPPIConfig = field(
        default_factory=lambda: MPPIConfig(
            n_samples=4096, n_horizon=50, n_action=N_ACTIONS, dt=0.01, lam=0.1,
            sigma=default_sigma(), savgol_window=9, savgol_polyorder=2,
            shift_warm_start=False,
            u_min=default_action_bounds()[0], u_max=default_action_bounds()[1],
            warm_start_decay=0.9, nominal_action=default_nominal_action(),
            sigma_scale_fn=ee_error_sigma_schedule(),
        )
    )
    model: WholeBodyParams = field(default_factory=WholeBodyParams)
    cost: WholeBodyCostParams = field(default_factory=WholeBodyCostParams)


class WholeBodyObs(NamedTuple):
    state: WholeBodyState
    ee_target: Pose
    base_target: Tensor  # (3,) station-keeping position for the base


class WholeBodyOutput(NamedTuple):
    action: Tensor        # (11,) first action of the plan
    u_seq: Tensor         # (H, 11)
    qdes: Tensor          # (7,) next arm position setpoint
    vdes: Tensor          # (7,) next arm velocity setpoint


ATTITUDE_MIN_SAMPLES = 2048
"""Validated sample-count floor for attitude mode: below K~2048 the closed
loop diverges; the position-cascade mode is the low-K-robust one."""


def rollout_cost_fns(params: WholeBodyMPPIParams):
    """(rollout_fn(v, obs), cost_fn(aux, v, u_prev, obs) -> S (K,)) of the
    whole-body task in operator form — the plain pipeline's task callables
    and the plain version of the cost kernel.

    With a leading scenario axis on the observation's fields, v is
    (B, K, H, A) and S (B, K): each scenario is rolled out and costed
    alone, so its S is bit-equal to an unbatched solve's.  (The rollout
    takes the batch in one pass too, but a batched matmul sums in another
    order than B small ones, and the softmin, at lambda = 0.1, turns a
    last-bit difference of S ~283 into 4e-6 of the plan.)"""
    cfg, cp, mp = params.mppi, params.cost, params.model
    spec = mp.chain()
    has_obstacles = cp.obstacle_weight and len(cp.obstacle_centers)

    def scenario(obs: WholeBodyObs, b: int) -> WholeBodyObs:
        return WholeBodyObs(
            state=WholeBodyState(base=Multirotor12State(*(x[b] for x in obs.state.base)),
                                 q=obs.state.q[b], qdot=obs.state.qdot[b]),
            ee_target=Pose(obs.ee_target.position[b], obs.ee_target.quat[b]),
            base_target=obs.base_target[b])

    def rollout_fn(v: Tensor, obs: WholeBodyObs):
        if obs.base_target.ndim == 1:
            return rollout(mp, obs.state, v, cfg.dt)
        return [rollout(mp, scenario(obs, b).state, v[b], cfg.dt) for b in range(v.shape[0])]

    def cost_fn(aux, v: Tensor, u_prev: Tensor, obs: WholeBodyObs) -> Tensor:
        if obs.base_target.ndim == 1:
            return cost_one(aux, v, obs)
        return torch.stack([cost_one(a, v[b], scenario(obs, b)) for b, a in enumerate(aux)])

    def cost_one(aux, v: Tensor, obs: WholeBodyObs) -> Tensor:
        ee, q, qdot, base = aux
        tpos, tquat = obs.ee_target.position, obs.ee_target.quat
        s = costs_mod.pose_stage_cost_pq(
            ee.position, ee.quat, tpos, tquat,
            cp.stage_pose_weight, cp.stage_orientation_weight, cp.ori_mode,
        )
        s = s + costs_mod.pose_terminal_cost_pq(
            ee.position, ee.quat, tpos, tquat,
            cp.terminal_pose_weight, cp.terminal_orientation_weight, cp.ori_mode,
        )
        if cp.base_pos_weight:
            s = s + costs_mod.position_stage_cost(
                base.pos, obs.base_target, cp.base_pos_weight / base.pos.shape[-2]
            )
        if cp.attitude_weight:
            s = s + cp.attitude_weight * torch.mean(base.tilt_squared(), dim=-1)
        if cp.omega_weight:
            s = s + cp.omega_weight * torch.mean(torch.sum(base.omega * base.omega, -1), -1)
        if cp.vel_weight:
            s = s + cp.vel_weight * torch.mean(torch.sum(base.vel * base.vel, -1), -1)
        if cp.stop_weight:
            d_stop = (base.pos[..., -1, :] + cp.stop_horizon * base.vel[..., -1, :]
                      - obs.base_target)
            s = s + cp.stop_weight * torch.sum(d_stop * d_stop, dim=-1)
        if cp.action_weight:
            s = s + costs_mod.action_cost(v, cp.action_weight, cp.gamma)
        if cp.joint_limit_weight:
            lo, hi = device_const(spec.lower, v), device_const(spec.upper, v)
            if cp.joint_limit_soft:
                s = s + costs_mod.joint_limit_soft_cost(
                    q, lo, hi, cp.gamma, weight=1e3 * cp.joint_limit_weight
                )
            else:
                s = s + cp.joint_limit_weight * costs_mod.joint_limit_cost(q, lo, hi, cp.gamma)
        if has_obstacles:
            s = s + costs_mod.sphere_obstacle_cost(
                ee.position,
                device_const(cp.obstacle_centers, v), device_const(cp.obstacle_radii, v),
                cp.obstacle_weight,
            )
        return s

    return rollout_fn, cost_fn


def make_whole_body_solver(
    params: WholeBodyMPPIParams = WholeBodyMPPIParams(),
    device="cuda",
    low_k_guard: str = "warn",
    group=None,
    n_local_samples: Optional[int] = None,
    n_scenarios: Optional[int] = None,
):
    """Build ``(step, init)`` for the whole-body solve.

    ``step(state, obs, z=None) -> (WholeBodyOutput, state)``; ``z`` is an
    optional (K, H, A) array of standard normals to use instead of the
    Philox stream.  ``init(seed) -> MPPIState``.  The solve is the plain
    pipeline (the port's ``backend="torch"``), on any device.

    ``low_k_guard`` polices the attitude-mode floor
    (:data:`ATTITUDE_MIN_SAMPLES`): ``"warn"``, ``"error"`` or ``"off"``.

    Sample-sharded: ``group`` is the ``torch.distributed`` group of the sample axis
    and ``n_local_samples`` this rank's share of ``n_samples``; ``z`` is
    then this rank's (n_local_samples, H, A) block.  ``n_scenarios``: B
    independent problems per call, every state, observation and output
    field with a leading B; ``init(seeds)`` then takes B seeds."""
    dev = resolve_device(device)
    cfg, mp = params.mppi, params.model
    if mp.control_mode == "attitude" and cfg.n_samples < ATTITUDE_MIN_SAMPLES:
        msg = (
            f"attitude-mode whole-body MPPI with n_samples={cfg.n_samples} is "
            f"below the validated floor K={ATTITUDE_MIN_SAMPLES}: the closed "
            "loop diverges. Use position-cascade mode for low K, raise "
            "n_samples, or pass low_k_guard='off' to proceed anyway."
        )
        if low_k_guard == "error":
            raise ValueError(msg)
        if low_k_guard == "warn":
            warnings.warn(msg, stacklevel=2)
        elif low_k_guard != "off":
            raise ValueError(f"unknown low_k_guard {low_k_guard!r}")

    inner = make_step(cfg, *rollout_cost_fns(params), group=group,
                      n_local_samples=n_local_samples, n_scenarios=n_scenarios)

    def step(state: MPPIState, obs: WholeBodyObs, z=None) -> Tuple[WholeBodyOutput, MPPIState]:
        qddot_prev = state.u_prev[..., 0, N_BASE_ACTIONS:]
        u_seq, new_state = inner(state, obs, z)
        u0 = u_seq[..., 0, :]
        arm_u0 = u0[..., N_BASE_ACTIONS:]
        vdes = obs.state.qdot + arm_u0 * cfg.dt
        qdes = obs.state.q + qddot_prev * cfg.dt + 0.5 * arm_u0 * cfg.dt * cfg.dt
        return WholeBodyOutput(action=u0, u_seq=u_seq, qdes=qdes, vdes=vdes), new_state

    def init(seed, dtype=torch.float32) -> MPPIState:
        if mp.control_mode == "position":
            u0 = torch.zeros((cfg.n_horizon, N_ACTIONS), dtype=dtype, device=dev)
        else:
            u0 = hover_nominal_action(mp, cfg.n_horizon, dtype, dev)
        sigma = _diag_sigma(cfg, dtype, dev)
        if n_scenarios is None:
            return MPPIState(u_prev=u0, sigma=sigma, seed=int(seed), step=0)
        return scenario_state(u0, sigma, seed, n_scenarios)

    return step, init
