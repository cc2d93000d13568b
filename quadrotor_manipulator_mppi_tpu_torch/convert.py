"""Carry the JAX package's configuration tree and solver state across.

MPPI has no learned weights: what crosses between the two packages is the
configuration (a tree of frozen dataclasses), the solver state and the
closed loop's plant state.  Batched solver states come across from the JAX
package's vmapped states (:func:`batched_state_from_numpy`).
:func:`params_from_dict` reads the plain JSON-able dict that the JAX
package's ``config.to_dict`` writes — ``{"__dataclass__": name, ...}``
nodes, ``{"__ndarray__": list, "dtype": str}`` arrays and
``{"__schedule__": {"kind": "ee_error", ...}}`` sigma schedules — through
this package's one reader, ``config.from_dict``, and rebuilds it from this
package's dataclasses (the whole-body, drone, arm,
multirotor, fixed-wing and mapped solvers, the loops, the graspable object,
the contact layer, the sensors, the occupancy grid, the ground contact,
the Lee gains, the wind, the mission and the HIL session's
``HilConfig``).  A mapped solver's
exploration schedule is a bare callable, which the JAX ``to_dict`` refuses:
its tree crosses with ``sigma_scale_fn=None``, and the caller puts the
port's schedule back (``solver.mapped.distance_to_go_scale``).
:func:`plant_from_numpy` reads the JAX plant-kernel state vector
(``pack_plant``); :func:`graspable_state_from_numpy` and
:func:`arm_loop_state_from_numpy` the object's and the arm node's states;
:func:`grid_from_numpy` an occupancy grid's log-odds;
:func:`wind_field_from_numpy` a static wind field and
:func:`mission_state_from_numpy` the mission machine's state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import from_dict
from .sim.arm_loop import ArmLoopState
from .sim.graspable import GraspableState
from .sim.occupancy import OccupancyGrid
from .sim.scenario import MissionState
from .sim.whole_body_loop import WholeBodyPlant
from .sim.wind import WindField
from .solver.arm import ArmMPPIParams
from .solver.drone import DroneMPPIParams
from .solver.mppi import MPPIState
from .solver.whole_body import WholeBodyMPPIParams
from .utils.device import resolve_device


def config_from_dict(d: dict) -> Any:
    """Any configuration tree of the registered dataclasses (solver
    parameters, ``FlightGains``, ``WholeBodyLoopConfig``, ``LoopConfig``,
    ``ArmLoopConfig``, ``GraspableParams``, ``ContactParams``, the
    fixed-wing airframe, ``LidarParams``, ``OccupancyParams``,
    ``MappedFlightConfig``, ``GroundContactParams``, ``LeeGains``,
    ``WindParams``, ``WindField``, ``MissionConfig``, the sensor and camera
    parameters, the bridge sessions' ``ArmMPPIParams``, ``DroneMPPIParams``
    and ``HilConfig``) from its JAX ``config.to_dict`` form, read by
    ``config.from_dict``."""
    return from_dict(d)


def _typed_from_dict(d: dict, cls):
    params = from_dict(d)
    if not isinstance(params, cls):
        got = type(params).__name__
        raise ValueError(f"expected a {cls.__name__} tree, got {got}: a {got} tree has no "
                         f"counterpart as a {cls.__name__}")
    return params


def params_from_dict(d: dict) -> WholeBodyMPPIParams:
    """The port's ``WholeBodyMPPIParams`` from the JAX ``config.to_dict``
    form of a ``WholeBodyMPPIParams``."""
    return _typed_from_dict(d, WholeBodyMPPIParams)


def drone_params_from_dict(d: dict) -> DroneMPPIParams:
    """The port's ``DroneMPPIParams`` from the JAX ``config.to_dict`` form
    of a ``DroneMPPIParams``."""
    return _typed_from_dict(d, DroneMPPIParams)


def arm_params_from_dict(d: dict) -> ArmMPPIParams:
    """The port's ``ArmMPPIParams`` from the JAX ``config.to_dict`` form of
    an ``ArmMPPIParams``."""
    return _typed_from_dict(d, ArmMPPIParams)


def state_from_numpy(u_prev, sigma, seed: int, device="cuda", step: int = 0) -> MPPIState:
    """An ``MPPIState`` from host arrays: warm start (H, A), sigma (A,), the
    64-bit Philox seed and the solve index."""
    dev = resolve_device(device)
    return MPPIState(
        u_prev=torch.tensor(np.asarray(u_prev, dtype=np.float32), device=dev),
        sigma=torch.tensor(np.asarray(sigma, dtype=np.float32), device=dev),
        seed=int(seed), step=int(step),
    )


def batched_state_from_numpy(u_prev, sigma, seeds, device="cuda", step: int = 0) -> MPPIState:
    """A scenario-batched ``MPPIState`` from host arrays: warm starts
    (B, H, A) and sigmas (B, A), e.g. the leaves of the JAX package's
    ``jax.vmap(init)`` states, with B Philox seeds of the port's own (the
    JAX keys have no counterpart) and the shared solve index."""
    u = np.asarray(u_prev, dtype=np.float32)
    sg = np.asarray(sigma, dtype=np.float32)
    seeds = [int(x) for x in seeds]
    if u.ndim != 3 or sg.shape != (u.shape[0], u.shape[2]) or len(seeds) != u.shape[0]:
        raise ValueError(f"expected u_prev (B, H, A), sigma (B, A) and B seeds, got "
                         f"{u.shape}, {sg.shape} and {len(seeds)} seeds")
    dev = resolve_device(device)
    return MPPIState(u_prev=torch.tensor(u, device=dev), sigma=torch.tensor(sg, device=dev),
                     seed=torch.tensor(seeds, dtype=torch.int64, device=dev), step=int(step))


def plant_from_numpy(vec46, device="cuda") -> WholeBodyPlant:
    """A ``WholeBodyPlant`` from the JAX ``pack_plant`` vector (46 floats:
    base position, quaternion, velocity, body rates, rotor speeds, arm q,
    qdot and the flight controller's state)."""
    from .ops.cuda.plant_kernel import STATE_SIZE, unpack_plant

    vec = np.asarray(vec46, dtype=np.float32)
    if vec.shape != (STATE_SIZE,):
        raise ValueError(f"expected a ({STATE_SIZE},) plant vector, got {vec.shape}")
    return unpack_plant(torch.tensor(vec, device=resolve_device(device)))


def graspable_state_from_numpy(pos, vel, attached, device="cuda") -> GraspableState:
    """A ``GraspableState`` from host arrays (the JAX state's leaves): the
    object's position and velocity (..., 3) and its attached flag (...)."""
    dev = resolve_device(device)
    return GraspableState(
        pos=torch.tensor(np.asarray(pos, dtype=np.float32), device=dev),
        vel=torch.tensor(np.asarray(vel, dtype=np.float32), device=dev),
        attached=torch.tensor(np.asarray(attached, dtype=bool), device=dev))


def arm_loop_state_from_numpy(q, qdot, t, phase2, hold_count, q_start, t_start,
                              solver: MPPIState, device="cuda") -> ArmLoopState:
    """An ``ArmLoopState`` from host arrays (the JAX state's leaves) and the
    port's solver state (``state_from_numpy``: the JAX key has no
    counterpart)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

    return ArmLoopState(q=f32(q), qdot=f32(qdot), t=f32(t),
                        phase2=torch.tensor(np.asarray(phase2, dtype=bool), device=dev),
                        hold_count=torch.tensor(np.asarray(hold_count, dtype=np.int32),
                                                device=dev),
                        q_start=f32(q_start), t_start=f32(t_start), solver=solver)


def grid_from_numpy(log_odds, device="cuda") -> OccupancyGrid:
    """An ``OccupancyGrid`` from a host (nx, ny, nz) log-odds array, e.g.
    the JAX grid's leaf."""
    lo = np.asarray(log_odds, dtype=np.float32)
    if lo.ndim != 3:
        raise ValueError(f"expected (nx, ny, nz) log-odds, got {lo.shape}")
    return OccupancyGrid(log_odds=torch.tensor(lo, device=resolve_device(device)))


def wind_field_from_numpy(field) -> WindField:
    """The port's ``WindField`` from a JAX ``WindField`` (or any object with
    its fields), the grids as float32 NumPy arrays."""
    def f32(x):
        return np.asarray(x, dtype=np.float32)

    return WindField(min_x=float(field.min_x), min_y=float(field.min_y),
                     res_x=float(field.res_x), res_y=float(field.res_y),
                     vertical_spacing_factors=f32(field.vertical_spacing_factors),
                     bottom_z=f32(field.bottom_z), top_z=f32(field.top_z), u=f32(field.u),
                     v=f32(field.v), w=f32(field.w))


def mission_state_from_numpy(phase, gear, gripper, gripper_cmd, payload_attached, land_cmd,
                             land_z, device="cuda") -> MissionState:
    """A ``MissionState`` from host values (the JAX state's leaves): the
    phase as int32, the two flags as bool, the rest float32."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

    def flag(x):
        return torch.tensor(np.asarray(x, dtype=bool), device=dev)

    return MissionState(phase=torch.tensor(np.asarray(phase, dtype=np.int32), device=dev),
                        gear=f32(gear), gripper=f32(gripper), gripper_cmd=f32(gripper_cmd),
                        payload_attached=flag(payload_attached), land_cmd=flag(land_cmd),
                        land_z=f32(land_z))
