"""The map-in-the-loop control step: sense -> map -> export -> solve ->
actuate.

Port of the JAX package's ``sim/mapped_loop.py``.  One 100 Hz control
period: a lidar scan of the hidden true scene, occupancy-grid ray
insertion, the top-N occupied voxels exported as obstacles (the safety
margin folded into live radii) or the grid's distance field, a map-aware
MPPI solve, and 10 x 1 kHz backstepping plant ticks tracking the emitted
position setpoint.

Every field of the loop state is a tensor: the plant, the flight
controller, the solver state (its seed and solve index as int64 device
tensors), the grid, and the lidar's own Philox key and draw counter (the
control-step index).  So on the card the whole control step is one
captured CUDA graph (:func:`make_mapped_episode`), and a checkpoint of the
state resumes the exact noise streams.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from ..models import multirotor as mr
from ..ops import sampling
from ..scenarios.common import hover_plant
from ..solver import mapped as mapped_solver
from ..solver.mppi import MPPIState, device_counters
from ..utils import graphs
from ..utils import rotations as rot
from ..utils.device import device_const, resolve_device
from . import closed_loop as cl
from . import flight_control as fc
from . import occupancy as occ
from . import sensors

Tensor = torch.Tensor


@dataclass(frozen=True)
class MappedFlightConfig:
    """The mapped-flight scene and its sensing and mapping geometry."""

    target: Tuple[float, float, float] = (9.0, 0.0, 1.8)
    start: Tuple[float, float, float] = (0.0, 0.0, 1.8)
    # The true scene (hidden from the solver): two spheres astride the line.
    true_centers: Tuple = ((3.5, 0.35, 1.8), (6.5, -0.5, 1.8))
    true_radii: Tuple = (1.0, 1.0)
    lidar: sensors.LidarParams = field(
        default_factory=lambda: sensors.LidarParams(n_beams=48, max_range=12.0, noise=0.01))
    grid: occ.OccupancyParams = field(
        default_factory=lambda: occ.OccupancyParams(
            origin=(-1.0, -4.0, 0.8), resolution=0.25, shape=(48, 32, 8),
            n_free_samples=24, max_range=10.0))
    max_obstacles: int = 64
    margin: float = 0.65  # voxel half-diagonal 0.217 + vehicle radius
    physics_dt: float = 0.001
    substeps: int = 10


class MappedFlightState(NamedTuple):
    plant: mr.MultirotorState
    ctrl: fc.FlightCtrlState
    solver: MPPIState
    grid: occ.OccupancyGrid
    lidar_seed: Tensor   # (1,) int64: the Philox key of the range noise
    lidar_step: Tensor   # (1,) int64: the control-step index, the draw's counter


def init_mapped_flight(cfg: MappedFlightConfig, solver_state: MPPIState, lidar_seed: int,
                       vehicle: Optional[mr.MultirotorParams] = None, dtype=torch.float32,
                       device="cuda") -> MappedFlightState:
    """At rest at ``cfg.start`` with the rotors at hover speed, an empty
    grid, the solver state's counters and the lidar's key ``lidar_seed`` as
    device tensors, the lidar counter at 0."""
    dev = resolve_device(device)
    veh = vehicle or mr.MultirotorParams()
    return MappedFlightState(
        plant=hover_plant(veh, cfg.start, dtype, dev),
        ctrl=fc.init_ctrl_state(veh.mass, dtype, dev),
        solver=device_counters(solver_state, dev), grid=occ.init_grid(cfg.grid, dtype, dev),
        lidar_seed=sampling.philox_keys(lidar_seed, dev).clone(),
        lidar_step=torch.zeros(1, dtype=torch.int64, device=dev))


def make_mapped_control_step(cfg: MappedFlightConfig, params: mapped_solver.MappedMPPIParams,
                             vehicle: Optional[mr.MultirotorParams] = None,
                             gains: Optional[fc.FlightGains] = None, device="cuda"):
    """Returns ``control_step(state, lidar_noise=None, z=None) -> (state,
    (pos, clearance))``: one control period from a :class:`MappedFlightState`.
    ``lidar_noise`` (n_beams,) and ``z`` (K, H, 3) optionally carry the
    range noise's and the solve's standard normals in place of their
    Philox streams.  ``clearance`` is the distance from the plant to the
    true scene's nearest sphere surface."""
    veh = vehicle or mr.MultirotorParams()
    gains = gains or fc.FlightGains()
    if params.use_esdf:
        # One source of grid geometry: the field is built from cfg.grid, so
        # the solver must query it with the same params (another frame reads
        # max_dist, "all clear", out of bounds).
        if params.esdf_params is None:
            params = dataclasses.replace(params, esdf_params=cfg.grid)
        elif params.esdf_params != cfg.grid:
            raise ValueError("MappedMPPIParams.esdf_params differs from MappedFlightConfig.grid"
                             " — the ESDF would be queried in the wrong frame")
    step, _ = mapped_solver.make_mapped_solver(params, device)
    lp, op = cfg.lidar, cfg.grid

    def control_step(state: MappedFlightState, lidar_noise: Optional[Tensor] = None,
                     z: Optional[Tensor] = None):
        plant = state.plant
        true_c = device_const(cfg.true_centers, plant.pos)
        true_r = device_const(cfg.true_radii, plant.pos)
        rotm = rot.quat_to_matrix(plant.quat)
        ranges = sensors.lidar_measure(lp, plant.pos, rotm, ground_z=-50.0,
                                       sphere_centers=true_c, sphere_radii=true_r,
                                       noise=lidar_noise, seed=state.lidar_seed,
                                       step=state.lidar_step)
        dirs_w = torch.einsum("ij,bj->bi", rotm, sensors.lidar_directions(lp, plant.pos))
        endpoints = plant.pos[None, :] + dirs_w * ranges[:, None]
        grid = occ.insert_rays(op, state.grid, plant.pos, endpoints,
                               torch.ones(lp.n_beams, dtype=torch.bool, device=plant.pos.device))
        centers, radii = occ.occupied_centers(op, grid, max_n=cfg.max_obstacles)
        radii_eff = torch.where(radii > 0.0, radii + cfg.margin, 0.0)
        dist_field = occ.distance_field(op, grid, max_dist=params.esdf_max_dist) \
            if params.use_esdf else None
        obs = mapped_solver.MappedObs(x=plant.pos, v=plant.vel,
                                      target=device_const(cfg.target, plant.pos),
                                      obst_centers=centers, obst_radii=radii_eff,
                                      dist_field=dist_field)
        out, solver = step(state.solver, obs, z)
        # A position-only setpoint: feeding the plan's velocity forward
        # removes the inner loop's damping.
        sp = fc.hover_setpoint(out.xdes)
        ctrl = state.ctrl
        for _ in range(cfg.substeps):
            u, ctrl = fc.backstepping_step(gains, veh, ctrl, sp, pos=plant.pos,
                                           vel_world=plant.vel, rpy=cl.rpy_of(plant),
                                           omega_body=plant.omega, dt=cfg.physics_dt)
            plant = mr.step(veh, plant, fc.allocate(veh, u), cfg.physics_dt)
        clearance = torch.amin(torch.linalg.norm(plant.pos - true_c, dim=-1) - true_r)
        return (MappedFlightState(plant=plant, ctrl=ctrl, solver=solver, grid=grid,
                                  lidar_seed=state.lidar_seed, lidar_step=state.lidar_step + 1),
                (plant.pos, clearance))

    return control_step


def make_mapped_episode(cfg: MappedFlightConfig, params: mapped_solver.MappedMPPIParams,
                        n_control_steps: int, vehicle: Optional[mr.MultirotorParams] = None,
                        gains: Optional[fc.FlightGains] = None, device="cuda",
                        graph: bool = True):
    """``run(state) -> (final state, (pos, clearance))``, each log stacked
    over ``n_control_steps`` control steps.  On the card (``graph=True``)
    one control step is captured at the first call and replayed per step;
    the returned state and logs are copies.  ``graph=False``, and the CPU,
    run it eagerly."""
    dev = resolve_device(device)
    control_step = make_mapped_control_step(cfg, params, vehicle, gains, dev)
    run = graphs.episode_runner(lambda state, _: control_step(state),
                                lambda state: (state.plant.pos, state.plant.pos[0]),
                                n_control_steps, dev, graph)
    return lambda state: run(state)
