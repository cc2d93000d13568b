"""Carry the JAX package's configuration tree and solver state across.

MPPI has no learned weights: what crosses between the two packages is the
configuration (a tree of frozen dataclasses), the solver state and the
closed loop's plant state.  Batched solver states come across from the JAX
package's vmapped states (:func:`batched_state_from_numpy`).
:func:`params_from_dict` reads the plain JSON-able dict that the JAX
package's ``config.to_dict`` writes — ``{"__dataclass__": name, ...}``
nodes, ``{"__ndarray__": list, "dtype": str}`` arrays and
``{"__schedule__": {"kind": "ee_error", ...}}`` sigma schedules — and
rebuilds it from this package's dataclasses.  :func:`plant_from_numpy`
reads the JAX plant-kernel state vector (``pack_plant``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .models.multirotor import MultirotorParams
from .models.whole_body import WholeBodyParams
from .sim.closed_loop import LoopConfig
from .sim.flight_control import FlightGains
from .sim.whole_body_loop import WholeBodyLoopConfig, WholeBodyPlant
from .solver.drone import DroneMPPIParams
from .solver.mppi import MPPIConfig, MPPIState
from .solver.whole_body import (
    WholeBodyCostParams, WholeBodyMPPIParams, ee_error_sigma_schedule,
)
from .utils.device import resolve_device

_REGISTRY = {cls.__name__: cls for cls in (
    MPPIConfig, MultirotorParams, WholeBodyParams, WholeBodyCostParams,
    WholeBodyMPPIParams, FlightGains, WholeBodyLoopConfig, DroneMPPIParams, LoopConfig,
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
    parameters, ``FlightGains``, ``WholeBodyLoopConfig``, ``LoopConfig``)
    from its JAX ``config.to_dict`` form."""
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
