"""Carry the JAX package's configuration tree and solver state across.

MPPI has no learned weights: what crosses between the two packages is the
configuration (a tree of frozen dataclasses), the solver state and the
closed loop's plant state.  Batched solver states come across from the JAX
package's vmapped states (:func:`batched_state_from_numpy`).
:func:`params_from_dict` reads the plain JSON-able dict that the JAX
package's ``config.to_dict`` writes — ``{"__dataclass__": name, ...}``
nodes, ``{"__ndarray__": list, "dtype": str}`` arrays and
``{"__schedule__": {"kind": "ee_error", ...}}`` sigma schedules — and
rebuilds it from this package's dataclasses (the whole-body, drone, arm,
multirotor, fixed-wing and mapped solvers, the loops, the graspable object,
the contact layer, the lidar and the occupancy grid).  A mapped solver's
exploration schedule is a bare callable, which the JAX ``to_dict`` refuses:
its tree crosses with ``sigma_scale_fn=None``, and the caller puts the
port's schedule back (``solver.mapped.distance_to_go_scale``).
:func:`plant_from_numpy` reads the JAX plant-kernel state vector
(``pack_plant``); :func:`graspable_state_from_numpy` and
:func:`arm_loop_state_from_numpy` the object's and the arm node's states;
:func:`grid_from_numpy` an occupancy grid's log-odds.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .models.fixed_wing import FwAeroParams, FwVehicleParams
from .models.multirotor import MultirotorParams
from .models.whole_body import WholeBodyParams
from .ops.costs import ArmCostParams
from .sim.arm_loop import ArmLoopConfig, ArmLoopState
from .sim.closed_loop import LoopConfig
from .sim.contact import ContactParams, WorldPrimitives
from .sim.flight_control import FlightGains
from .sim.graspable import GraspableParams, GraspableState
from .sim.mapped_loop import MappedFlightConfig
from .sim.occupancy import OccupancyGrid, OccupancyParams
from .sim.sensors import LidarParams
from .sim.whole_body_loop import WholeBodyLoopConfig, WholeBodyPlant
from .solver.arm import ArmMPPIParams
from .solver.drone import DroneMPPIParams
from .solver.fixed_wing import FwMPPIParams
from .solver.mapped import MappedMPPIParams
from .solver.mppi import MPPIConfig, MPPIState
from .solver.multirotor_mppi import MultirotorCostParams, MultirotorMPPIParams
from .solver.whole_body import (
    WholeBodyCostParams, WholeBodyMPPIParams, ee_error_sigma_schedule,
)
from .utils.device import resolve_device

_REGISTRY = {cls.__name__: cls for cls in (
    MPPIConfig, MultirotorParams, WholeBodyParams, WholeBodyCostParams,
    WholeBodyMPPIParams, FlightGains, WholeBodyLoopConfig, DroneMPPIParams, LoopConfig,
    ArmCostParams, ArmMPPIParams, ArmLoopConfig, GraspableParams, ContactParams, WorldPrimitives,
    MultirotorCostParams, MultirotorMPPIParams, FwAeroParams, FwVehicleParams, FwMPPIParams,
    LidarParams, OccupancyParams, MappedMPPIParams, MappedFlightConfig,
)}
_SCHEDULES = {"ee_error": ee_error_sigma_schedule}


def _from_dict(data: Any) -> Any:
    if isinstance(data, dict):
        if "__ndarray__" in data:
            return np.asarray(data["__ndarray__"], dtype=data["dtype"])
        if "__schedule__" in data:
            spec = dict(data["__schedule__"])
            kind = spec.pop("kind")
            if kind not in _SCHEDULES:
                raise ValueError(f"unknown sigma schedule {kind!r}")
            return _SCHEDULES[kind](**spec)
        if "__dataclass__" in data:
            name = data["__dataclass__"]
            if name not in _REGISTRY:
                raise ValueError(f"no counterpart for config dataclass {name!r}")
            cls = _REGISTRY[name]
            kwargs = {k: _from_dict(v) for k, v in data.items() if k != "__dataclass__"}
            for f in dataclasses.fields(cls):
                if isinstance(kwargs.get(f.name), list) and "tuple" in str(f.type).lower():
                    kwargs[f.name] = tuple(
                        tuple(x) if isinstance(x, list) else x for x in kwargs[f.name]
                    )
            return cls(**kwargs)
        return {k: _from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [_from_dict(x) for x in data]
    return data


def config_from_dict(d: dict) -> Any:
    """Any configuration tree of the registered dataclasses (solver
    parameters, ``FlightGains``, ``WholeBodyLoopConfig``, ``LoopConfig``,
    ``ArmLoopConfig``, ``GraspableParams``, ``ContactParams``, the
    fixed-wing airframe, ``LidarParams``, ``OccupancyParams``,
    ``MappedFlightConfig``) from its JAX ``config.to_dict`` form."""
    return _from_dict(d)


def _typed_from_dict(d: dict, cls):
    params = _from_dict(d)
    if not isinstance(params, cls):
        raise ValueError(f"expected a {cls.__name__} tree, got {type(params).__name__}")
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
