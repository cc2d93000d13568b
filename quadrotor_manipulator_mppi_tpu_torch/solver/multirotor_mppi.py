"""Quadrotor-only MPPI over the 12-state multirotor.

Port of the JAX package's ``solver/multirotor_mppi.py``: attitude-mode
actions [thrust, roll/pitch/yaw setpoints] (or the direct wrench) rolled
through the whole-body model's base rollouts with no arm, costed by the
reference's position terms (stage x100, terminal x20 squared error) plus
attitude, body-rate and velocity regularization.  The step is the plain
pipeline (``solver/mppi.make_step``), on the card by default, as the JAX
preset runs XLA; with ``n_scenarios=B`` it solves B problems per call,
every state, observation and output field with a leading B; with ``group``
and ``n_local_samples`` it is sample-sharded
(``parallel/sharded.make_sharded_solver``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.multirotor import Multirotor12State, MultirotorParams
from ..models.whole_body import (
    WholeBodyParams, WholeBodyState, _base_rollout_attitude, _base_rollout_parallel,
    _rotor_lag_matrix,
)
from ..ops import costs as costs_mod
from ..utils.device import device_const, resolve_device
from .mppi import MPPIConfig, MPPIState, _diag_sigma, make_step, scenario_lift, scenario_state

Tensor = torch.Tensor

N_ACTIONS = 4  # [thrust, roll_des, pitch_des, yaw_des] (attitude mode)


def default_sigma() -> np.ndarray:
    return np.asarray([30.0, 0.15, 0.15, 0.1])


def hover_nominal(vehicle: MultirotorParams) -> np.ndarray:
    return np.asarray([vehicle.mass * 9.81, 0.0, 0.0, 0.0])


@dataclass(frozen=True)
class MultirotorCostParams:
    stage_weight: float = 100.0
    terminal_weight: float = 20.0
    attitude_weight: float = 200.0
    omega_weight: float = 5.0
    vel_weight: float = 10.0


@dataclass(frozen=True)
class MultirotorMPPIParams:
    mppi: MPPIConfig = field(
        default_factory=lambda: MPPIConfig(
            n_samples=1024, n_horizon=30, n_action=N_ACTIONS, dt=0.01, lam=0.1,
            sigma=default_sigma(), savgol_window=9,
            u_min=np.asarray([0.0, -0.35, -0.35, -0.6]),
            u_max=np.asarray([300.0, 0.35, 0.35, 0.6]),
            warm_start_decay=0.9, nominal_action=hover_nominal(MultirotorParams()),
        )
    )
    model: WholeBodyParams = field(
        default_factory=lambda: WholeBodyParams(arm_mass_lump=0.0, couple_arm_gravity=False)
    )
    cost: MultirotorCostParams = field(default_factory=MultirotorCostParams)


class MultirotorObs(NamedTuple):
    state: Multirotor12State  # fields (3,); (B, 3) for a batch
    target: Tensor            # (3,) position; (B, 3)


class MultirotorOutput(NamedTuple):
    action: Tensor  # (4,); (B, 4)
    u_seq: Tensor   # (H, 4); (B, H, 4)


def base_rollout(params: MultirotorMPPIParams, state: Multirotor12State, v: Tensor):
    """The base trajectories (``models.whole_body.BaseTraj``) of the action
    sequences v (*B, K, H, 4) from ``state`` (fields (*B, 3)): the rotor lag
    on the thrust, then the attitude (or wrench) rollout with no arm."""
    cfg, mp = params.mppi, params.model
    wb_state = WholeBodyState(base=state, q=None, qdot=None)
    if mp.rotor_lag_tau > 0.0:
        f = device_const(_rotor_lag_matrix(v.shape[-2], cfg.dt, mp.rotor_lag_tau), v)
        thrust = torch.einsum("ts,...ks->...kt", f, v[..., 0])[..., None]
        v = torch.cat([thrust, v[..., 1:]], dim=-1)
    if mp.control_mode == "attitude":
        return _base_rollout_attitude(mp, wb_state, v, cfg.dt)
    return _base_rollout_parallel(mp, wb_state, v, cfg.dt)


def make_multirotor_solver(
    params: MultirotorMPPIParams = MultirotorMPPIParams(),
    device="cuda",
    n_scenarios: Optional[int] = None,
    group: Optional[Any] = None,
    n_local_samples: Optional[int] = None,
):
    """Returns ``(step, init)``: ``step(state, obs, z=None) ->
    (MultirotorOutput, state)`` and ``init(seed, dtype=torch.float32) ->
    MPPIState`` (hover-thrust warm start) on ``device``.  ``z`` optionally
    carries the step's standard normals (K, H, 4) in place of the Philox
    stream.  ``n_scenarios=B`` solves B problems per call (``init(seed)``
    then takes one seed or B).  ``group`` and ``n_local_samples`` (the JAX
    factory's ``axis_name`` and ``n_local_samples``) make it a
    sample-sharded solve; ``z`` is then this rank's block."""
    dev = resolve_device(device)
    cfg, cp, mp = params.mppi, params.cost, params.model
    # Per-scenario (B, 3) targets meet the (B, K, H, 3) trajectories with a
    # sample axis (and, for the stage term, a step axis) inserted.
    lift = scenario_lift(n_scenarios)

    def rollout_fn(v: Tensor, obs: MultirotorObs):
        return base_rollout(params, obs.state, v)

    def cost_fn(base, v: Tensor, u_prev: Tensor, obs: MultirotorObs) -> Tensor:
        s = costs_mod.position_stage_cost(base.pos, lift(obs.target, 2), cp.stage_weight)
        s = s + costs_mod.position_terminal_cost(base.pos, lift(obs.target, 1),
                                                 cp.terminal_weight)
        if cp.attitude_weight:
            s = s + cp.attitude_weight * torch.mean(base.tilt_squared(), dim=-1)
        if cp.omega_weight:
            s = s + cp.omega_weight * torch.mean(torch.sum(base.omega * base.omega, -1), -1)
        if cp.vel_weight:
            s = s + cp.vel_weight * torch.mean(torch.sum(base.vel * base.vel, -1), -1)
        return s

    inner = make_step(cfg, rollout_fn, cost_fn, group, n_local_samples, n_scenarios)

    def step(state: MPPIState, obs: MultirotorObs, z=None) -> Tuple[MultirotorOutput, MPPIState]:
        u_seq, new_state = inner(state, obs, z)
        return MultirotorOutput(action=u_seq[..., 0, :], u_seq=u_seq), new_state

    def init(seed, dtype=torch.float32) -> MPPIState:
        nominal = torch.tensor(hover_nominal(mp.vehicle), dtype=dtype, device=dev)
        u_prev = nominal.expand(cfg.n_horizon, N_ACTIONS).clone()
        sigma = _diag_sigma(cfg, dtype, dev)
        if n_scenarios is None:
            return MPPIState(u_prev=u_prev, sigma=sigma, seed=int(seed), step=0)
        return scenario_state(u_prev, sigma, seed, n_scenarios)

    return step, init
