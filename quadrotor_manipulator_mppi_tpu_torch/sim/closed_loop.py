"""Closed-loop simulation harness of the octorotor plant.

Port of the JAX package's ``sim/closed_loop.py``.  Each control step runs
one MPPI solve, turns its output into the inner loop's setpoint, then runs
``substeps`` physics + flight-controller ticks (default 10: 100 Hz control
over 1 kHz physics).  Where the JAX package scans, the episode on the card
captures one control step in a CUDA graph (``utils/graphs.graphed``) and
replays it once per step: the loop state is updated in place in static
buffers, the solve index advances on the card, and each step writes its
log row into preallocated (n_control_steps, 3) buffers at a device step
index.  The eager loop (``graph=False``, and always on the CPU) runs the
same control step and never waits for the card either.  :func:`rpy_of` is
the plant attitude in the layout the flight controllers consume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..models import multirotor
from ..models.multirotor import MultirotorParams, MultirotorState
from ..solver.mppi import MPPIState, device_counters
from ..utils import graphs
from ..utils import rotations as rot
from ..utils.device import resolve_device
from . import flight_control as fc

Tensor = torch.Tensor


@dataclass(frozen=True)
class LoopConfig:
    physics_dt: float = 0.001    # 1 kHz physics
    substeps: int = 10           # -> 100 Hz control
    controller: str = "pid"      # "pid" | "backstepping"
    extra_mass: float = 0.0


class LoopState(NamedTuple):
    plant: MultirotorState
    ctrl: fc.FlightCtrlState
    solver: Any        # the MPPI solver's state
    setpoint: fc.FlightSetpoint


def rpy_of(state: MultirotorState) -> Tensor:
    """Plant attitude as (roll, pitch, yaw)."""
    ang = rot.matrix_to_euler(rot.quat_to_matrix(state.quat), "ZYX")
    return torch.stack([ang[..., 2], ang[..., 1], ang[..., 0]], dim=-1)


_CONTROLLERS = {"pid": fc.pid_step, "backstepping": fc.backstepping_step}


def make_episode(
    cfg: LoopConfig,
    vehicle: MultirotorParams,
    gains: fc.FlightGains,
    solver_step: Callable[..., Tuple[Any, Any]],
    make_obs: Callable[[MultirotorState], Any],
    setpoint_of: Callable[[Any, MultirotorState], fc.FlightSetpoint],
    n_control_steps: int,
    graph: bool = True,
):
    """Build an episode runner.

    ``solver_step(solver_state, obs) -> (output, solver_state)`` is any MPPI
    preset step (called as ``solver_step(solver_state, obs, z_i)`` when
    ``run`` is given ``z``); ``make_obs`` maps the plant state to the
    solver's observation; ``setpoint_of(output, plant)`` turns the solver
    output into the inner loop's setpoint (the drone preset's
    ``hover_setpoint(out.xdes)``).

    Returns ``run(loop_state, z=None) -> (final_state, (pos, rpy, vel))``
    with each log stacked over the control steps.  ``z`` (n_control_steps,
    K, H, A) optionally carries the solver's standard normals, one draw per
    control step, in place of its Philox stream.

    On the card (``graph=True``) the first call captures one control step
    in a CUDA graph and every call replays it ``n_control_steps`` times
    (loop states of other shapes get a graph of their own); every field of
    the loop state must be a tensor, and an ``MPPIState`` solver state
    comes back with its seed and solve index as int64 device tensors.  The
    returned state and logs are copies.  ``graph=False`` runs the control
    steps eagerly; so does the CPU."""
    if cfg.controller not in _CONTROLLERS:
        raise ValueError(f"unknown controller {cfg.controller!r}")
    ctrl_fn = _CONTROLLERS[cfg.controller]

    def physics_tick(plant: MultirotorState, ctrl: fc.FlightCtrlState, sp: fc.FlightSetpoint):
        u, ctrl = ctrl_fn(gains, vehicle, ctrl, sp, pos=plant.pos, vel_world=plant.vel,
                          rpy=rpy_of(plant), omega_body=plant.omega, dt=cfg.physics_dt)
        plant = multirotor.step(vehicle, plant, fc.allocate(vehicle, u), cfg.physics_dt,
                                extra_mass=cfg.extra_mass)
        return plant, ctrl

    def control_step(state: LoopState, z: Optional[Tensor]):
        obs = make_obs(state.plant)
        if z is None:
            out, solver = solver_step(state.solver, obs)
        else:
            out, solver = solver_step(state.solver, obs, z)
        sp = setpoint_of(out, state.plant)
        plant, ctrl = state.plant, state.ctrl
        for _ in range(cfg.substeps):
            plant, ctrl = physics_tick(plant, ctrl, sp)
        return (LoopState(plant=plant, ctrl=ctrl, solver=solver, setpoint=sp),
                (plant.pos, rpy_of(plant), plant.vel))

    runners = {}  # the episode runner of each device

    def run(state: LoopState, z=None):
        if z is not None and len(z) != n_control_steps:
            raise ValueError(f"z carries {len(z)} steps, the episode {n_control_steps}")
        dev = state.plant.pos.device
        if graph and dev.type == "cuda" and isinstance(state.solver, MPPIState):
            state = state._replace(solver=device_counters(state.solver, dev))
        if dev not in runners:
            runners[dev] = graphs.episode_runner(
                control_step, lambda s: (s.plant.pos, s.plant.pos, s.plant.vel), n_control_steps,
                dev, graph)
        return runners[dev](state, z)

    return run


def init_loop_state(
    cfg: LoopConfig,
    vehicle: MultirotorParams,
    solver_state: Any,
    pos=(0.0, 0.0, 0.1),
    dtype=torch.float32,
    device="cuda",
) -> LoopState:
    """Rest at ``pos`` with the rotors at hover speed, so episodes begin
    near equilibrium."""
    dev = resolve_device(device)
    plant = multirotor.init_state(vehicle, pos=pos, dtype=dtype, device=dev)
    plant = plant._replace(rotor_speed=torch.full(
        (vehicle.n_rotors,), vehicle.hover_rotor_speed(cfg.extra_mass), dtype=dtype, device=dev))
    return LoopState(
        plant=plant,
        ctrl=fc.init_ctrl_state(vehicle.mass + cfg.extra_mass, dtype, dev),
        solver=solver_state,
        setpoint=fc.hover_setpoint(pos, dtype, dev),
    )
