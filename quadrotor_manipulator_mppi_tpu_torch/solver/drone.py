"""Drone point-mass MPPI preset.

Port of the JAX package's ``solver/drone.py``: sample xyz accelerations for
a point-mass model and emit the next position and velocity setpoint, which
the inner-loop flight controller tracks.  The preset's size is the
reference's: K=1000, H=32, A=3, dt=0.01, sigma=30, lambda=0.1,
SavGol(5, 2), stage cost 100x the squared position error over t < H-1 and
terminal cost 20x at H-1; no clamp.

The step is the plain pipeline (``solver/mppi.make_step`` with
``ops/integrators.double_integrate`` and the two position costs), on the
card by default.  That is the JAX package's own design: its drone preset
runs the XLA pipeline, which is ``make_drone_solver``'s only path, and the
fused two-pass drone kernels are a separate entry point
(``ops/cuda/drone_kernel.solve_drone_cuda`` here, ``solve_drone_pallas``
there).  Both draw the Philox stream of ``ops/sampling.py``, so the first
step from a seed and the kernel solve on that seed use the same noise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..ops import costs as costs_mod
from ..ops import integrators
from ..utils.device import resolve_device
from .mppi import MPPIConfig, MPPIState, init_state, make_step, scenario_lift

Tensor = torch.Tensor

# The reference's hardcoded waypoint.
DEFAULT_TARGET = (1.0, 2.0, 3.4)


class DroneObs(NamedTuple):
    x: Tensor       # (3,) position; (B, 3) for a batch
    v: Tensor       # (3,) velocity
    target: Tensor  # (3,) goal position


class DroneOutput(NamedTuple):
    xdes: Tensor    # (3,) next position setpoint; (B, 3) for a batch
    vdes: Tensor    # (3,) next velocity setpoint
    u_seq: Tensor   # (H, 3) updated acceleration plan; (B, H, 3)


@dataclass(frozen=True)
class DroneMPPIParams:
    mppi: MPPIConfig = field(
        default_factory=lambda: MPPIConfig(
            n_samples=1000, n_horizon=32, n_action=3, dt=0.01, lam=0.1, sigma=30.0,
            savgol_window=5, savgol_polyorder=2,
        )
    )
    stage_weight: float = 100.0
    terminal_weight: float = 20.0


def make_drone_solver(
    params: DroneMPPIParams = DroneMPPIParams(),
    device="cuda",
    group: Optional[Any] = None,
    n_local_samples: Optional[int] = None,
    n_scenarios: Optional[int] = None,
):
    """Returns ``(step, init)``: ``step(state, obs, z=None) -> (DroneOutput,
    state)`` and ``init(seed, dtype=torch.float32) -> MPPIState`` on
    ``device``.  ``z`` optionally carries the step's standard normals
    (K, H, 3) in place of the Philox stream.

    ``group`` and ``n_local_samples`` (the JAX builder's ``axis_name`` and
    ``n_local_samples``) make it a sample-sharded solve, so the preset plugs
    into ``parallel/sharded.make_sharded_solver``.  ``n_scenarios=B`` solves
    B problems per call, as ``jax.vmap`` of the JAX step: every state,
    observation and output field with a leading B, ``z`` (B, K, H, 3), and
    ``init(seed)`` takes one seed (spread over the scenarios with
    ``parallel.sharded.scenario_seeds``) or B seeds."""
    dev = resolve_device(device)
    cfg = params.mppi
    # Per-scenario (B, 3) observations meet the (B, K, H, 3) samples with a
    # sample axis (and, for the stage terms, a step axis) inserted.
    lift = scenario_lift(n_scenarios)

    def rollout(v: Tensor, obs: DroneObs) -> Tensor:
        traj, _ = integrators.double_integrate(v, lift(obs.x, 1), lift(obs.v, 1), cfg.dt)
        return traj

    def cost(traj: Tensor, v: Tensor, u_prev: Tensor, obs: DroneObs) -> Tensor:
        s = costs_mod.position_stage_cost(traj, lift(obs.target, 2), params.stage_weight)
        return s + costs_mod.position_terminal_cost(traj, lift(obs.target, 1),
                                                    params.terminal_weight)

    inner = make_step(cfg, rollout, cost, group, n_local_samples, n_scenarios)

    def step(state: MPPIState, obs: DroneObs, z=None) -> Tuple[DroneOutput, MPPIState]:
        u_seq, new_state = inner(state, obs, z)
        u0 = u_seq[..., 0, :]
        vdes = obs.v + cfg.dt * u0
        xdes = obs.x + obs.v * cfg.dt + 0.5 * u0 * cfg.dt * cfg.dt
        return DroneOutput(xdes=xdes, vdes=vdes, u_seq=u_seq), new_state

    def init(seed, dtype=torch.float32) -> MPPIState:
        return init_state(cfg, seed, dtype, dev, n_scenarios)

    return step, init
