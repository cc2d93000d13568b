"""Map-aware point-mass MPPI: obstacles from an online occupancy map.

Port of the JAX package's ``solver/mapped.py``.  The obstacles arrive in
the OBSERVATION, each solve: the occupancy grid's top-N occupied voxels as
spheres (``sim/occupancy.occupied_centers``, inert slots with radius 0, the
margin folded into live radii by the caller), or, with ``use_esdf``, the
grid's distance field queried along every sampled trajectory.  The
emitted position setpoint is the plan's own position ``lookahead`` steps
ahead, blended toward the target inside ``hold_radius``.

The step is the plain pipeline (``solver/mppi.make_step``), on the card by
default, as the JAX preset runs XLA.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import costs as costs_mod
from ..ops import integrators
from ..utils.device import resolve_device
from .mppi import MPPIConfig, MPPIState, init_state, make_step

Tensor = torch.Tensor


class MappedObs(NamedTuple):
    x: Tensor              # (3,) position
    v: Tensor              # (3,) velocity
    target: Tensor         # (3,)
    obst_centers: Tensor   # (N, 3) obstacle spheres (map export)
    obst_radii: Tensor     # (N,)  0 = inert slot
    # The distance field (sim/occupancy.distance_field), read instead of the
    # spheres when MappedMPPIParams.use_esdf is set.
    dist_field: Optional[Tensor] = None


class MappedOutput(NamedTuple):
    xdes: Tensor
    vdes: Tensor
    u_seq: Tensor


def distance_to_go_scale(obs: MappedObs) -> Tensor:
    """The preset's exploration schedule: full sigma in the open field,
    down to 15% near the goal (distance to go over 3 m, clamped to
    [0.15, 1])."""
    return torch.clamp(torch.linalg.norm(obs.x - obs.target) / 3.0, 0.15, 1.0)


@dataclass(frozen=True)
class MappedMPPIParams:
    mppi: MPPIConfig = field(
        default_factory=lambda: MPPIConfig(
            n_samples=1024, n_horizon=32, n_action=3, dt=0.05, lam=0.1, sigma=6.0,
            savgol_window=5, savgol_polyorder=2, shift_warm_start=True, u_min=-6.0, u_max=6.0,
            sigma_scale_fn=distance_to_go_scale,
        )
    )
    stage_weight: float = 6.0
    terminal_weight: float = 60.0
    obstacle_weight: float = 2000.0
    speed_weight: float = 0.5
    max_speed: float = 2.0
    # The setpoint is the plan's predicted position this many steps ahead.
    lookahead: int = 8
    # |z - target_z| corridor (0 disables): with a planar lidar the map only
    # covers the flight plane, so the task is kept in it.
    altitude_weight: float = 0.0
    # ESDF mode: the rollout queries the distance field instead of the
    # sphere export; esdf_params is the OccupancyParams the field was built
    # with.
    use_esdf: bool = False
    esdf_params: object = None
    esdf_margin: float = 0.9          # clearance floor [m]
    esdf_max_dist: float = 2.0
    esdf_weight: float = 2000.0
    # Inside this radius the setpoint blends linearly toward the target.
    hold_radius: float = 1.5


def make_mapped_solver(params: MappedMPPIParams = MappedMPPIParams(), device="cuda"):
    """Returns ``(step, init)``: ``step(state, obs, z=None) ->
    (MappedOutput, state)`` and ``init(seed, dtype=torch.float32) ->
    MPPIState`` on ``device``.  ``z`` optionally carries the step's
    standard normals (K, H, 3) in place of the Philox stream."""
    dev = resolve_device(device)
    cfg = params.mppi

    def rollout(v: Tensor, obs: MappedObs):
        return integrators.double_integrate(v, obs.x, obs.v, cfg.dt)

    def cost(aux, v: Tensor, u_prev: Tensor, obs: MappedObs) -> Tensor:
        traj, vel = aux
        dist = torch.linalg.norm(traj - obs.target, dim=-1)       # (K, H)
        s = params.stage_weight * torch.sum(dist, dim=-1)
        s = s + params.terminal_weight * dist[..., -1]
        if params.use_esdf:
            from ..sim import occupancy as occ

            clearance = occ.query_distance(params.esdf_params, obs.dist_field, traj,
                                           max_dist=params.esdf_max_dist)
            pen = torch.clamp(params.esdf_margin - clearance, min=0.0)
            s = s + params.esdf_weight * torch.sum(pen * pen, dim=-1)
        else:
            s = s + costs_mod.sphere_obstacle_cost(traj, obs.obst_centers, obs.obst_radii,
                                                   params.obstacle_weight)
        speed = torch.linalg.norm(vel, dim=-1)
        s = s + params.speed_weight * torch.sum(
            torch.clamp(speed - params.max_speed, min=0.0) ** 2, dim=-1)
        if params.altitude_weight:
            s = s + params.altitude_weight * torch.sum(
                torch.abs(traj[..., 2] - obs.target[2]), dim=-1)
        return s

    inner = make_step(cfg, rollout, cost)
    look = min(params.lookahead, cfg.n_horizon) - 1

    def step(state: MPPIState, obs: MappedObs, z=None) -> Tuple[MappedOutput, MPPIState]:
        u_seq, new_state = inner(state, obs, z)
        plan, plan_v = integrators.double_integrate(u_seq[None], obs.x, obs.v, cfg.dt)
        xdes, vdes = plan[0, look], plan_v[0, look]
        if params.hold_radius > 0.0:
            w = torch.clamp(1.0 - torch.linalg.norm(obs.x - obs.target) / params.hold_radius,
                            0.0, 1.0)
            xdes = (1.0 - w) * xdes + w * obs.target
            vdes = (1.0 - w) * vdes
        return MappedOutput(xdes=xdes, vdes=vdes, u_seq=u_seq), new_state

    def init(seed, dtype=torch.float32) -> MPPIState:
        return init_state(cfg, seed, dtype, dev)

    return step, init
