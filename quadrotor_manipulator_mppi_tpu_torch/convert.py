"""Carry the JAX package's configuration tree and solver state across.

MPPI has no learned weights: what crosses between the two packages is the
configuration (a tree of frozen dataclasses) and the solver state.
:func:`params_from_dict` reads the plain JSON-able dict that the JAX
package's ``config.to_dict`` writes — ``{"__dataclass__": name, ...}``
nodes, ``{"__ndarray__": list, "dtype": str}`` arrays and
``{"__schedule__": {"kind": "ee_error", ...}}`` sigma schedules — and
rebuilds it from this package's dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .models.multirotor import MultirotorParams
from .models.whole_body import WholeBodyParams
from .solver.mppi import MPPIConfig, MPPIState
from .solver.whole_body import (
    WholeBodyCostParams, WholeBodyMPPIParams, ee_error_sigma_schedule,
)
from .utils.device import resolve_device

_REGISTRY = {cls.__name__: cls for cls in (
    MPPIConfig, MultirotorParams, WholeBodyParams, WholeBodyCostParams,
    WholeBodyMPPIParams,
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


def params_from_dict(d: dict) -> WholeBodyMPPIParams:
    """The port's ``WholeBodyMPPIParams`` from the JAX ``config.to_dict``
    form of a ``WholeBodyMPPIParams``."""
    params = _from_dict(d)
    if not isinstance(params, WholeBodyMPPIParams):
        raise ValueError(f"expected a WholeBodyMPPIParams tree, got {type(params).__name__}")
    return params


def state_from_numpy(u_prev, sigma, seed: int, device="cuda", step: int = 0) -> MPPIState:
    """An ``MPPIState`` from host arrays: warm start (H, A), sigma (A,), the
    64-bit Philox seed and the solve index."""
    dev = resolve_device(device)
    return MPPIState(
        u_prev=torch.tensor(np.asarray(u_prev, dtype=np.float32), device=dev),
        sigma=torch.tensor(np.asarray(sigma, dtype=np.float32), device=dev),
        seed=int(seed), step=int(step),
    )
