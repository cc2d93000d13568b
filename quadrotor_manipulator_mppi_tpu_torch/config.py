"""Unified typed configuration tree with JSON round trip.

Every tunable lives in a frozen dataclass; this module gives the tree one
serialization surface and is the package's one reader of it:

    cfg = ExperimentConfig()                       # all defaults
    save_config(cfg, "exp.json")
    cfg = load_config("exp.json")                  # exact round trip
    cfg2 = replace_path(cfg, "solver.mppi.lam", 0.05)

The JSON is the JAX package's, node for node: ``{"__dataclass__": name,
...fields}`` for a dataclass, ``{"__ndarray__": list, "dtype": str}`` for a
NumPy array (a tensor field is written the same way and reads back as a
NumPy array), and ``{"__schedule__": {"kind": ..., ...}}`` for an
exploration schedule, so a file saved by either package loads in the
other.  A dataclass reads back as this package's class of the same name
(:func:`register` adds one); ``convert.py`` reads the JAX package's trees
through :func:`from_dict`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, is_dataclass
from typing import Any

import numpy as np
import torch

from .bridge.config import HilConfig
from .models.fixed_wing import FwAeroParams, FwVehicleParams, LiftDragParams
from .models.multirotor import GroundContactParams, MultirotorParams
from .models.whole_body import WholeBodyParams
from .ops.costs import ArmCostParams
from .sim.arm_loop import ArmLoopConfig
from .sim.closed_loop import LoopConfig
from .sim.contact import ContactParams, WorldPrimitives
from .sim.depth_camera import DepthCameraParams
from .sim.flight_control import FlightGains
from .sim.geotag import GeotagParams
from .sim.gimbal import GimbalParams
from .sim.graspable import GraspableParams
from .sim.lee_controller import LeeGains
from .sim.mapped_loop import MappedFlightConfig
from .sim.occupancy import OccupancyParams
from .sim.scenario import MissionConfig
from .sim.sensors import (
    BarometerParams, GpsParams, ImuParams, LidarParams, MagnetometerParams, OdometryParams,
    OpticalFlowParams,
)
from .sim.whole_body_loop import WholeBodyLoopConfig
from .sim.wind import WindField, WindParams
from .solver.arm import ArmMPPIParams
from .solver.drone import DroneMPPIParams
from .solver.fixed_wing import FwMPPIParams
from .solver.mapped import MappedMPPIParams
from .solver.mppi import MPPIConfig
from .solver.multirotor_mppi import MultirotorCostParams, MultirotorMPPIParams
from .solver.whole_body import WholeBodyCostParams, WholeBodyMPPIParams, ee_error_sigma_schedule


def to_dict(obj: Any) -> Any:
    """Dataclass tree -> plain JSON-able structure."""
    if is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__,
                **{f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if callable(obj) and not isinstance(obj, type):
        # Exploration schedules carry a declarative identity
        # (solver/whole_body.ee_error_sigma_schedule) so the tree stays
        # round-trippable; an anonymous callable is a config bug.
        spec = getattr(obj, "__qmm_schedule__", None)
        if spec is None:
            raise TypeError(f"config field holds a non-serializable callable {obj!r}; "
                            "use a registered schedule factory (__qmm_schedule__)")
        return {"__schedule__": spec}
    return obj


_SCHEDULE_FACTORIES = {"ee_error": ee_error_sigma_schedule}


def register_schedule(kind: str, factory) -> None:
    """Register a schedule factory for ``{"__schedule__": {"kind": kind}}``."""
    _SCHEDULE_FACTORIES[kind] = factory


def _build_schedule(spec: dict):
    spec = dict(spec)
    kind = spec.pop("kind")
    if kind not in _SCHEDULE_FACTORIES:
        raise ValueError(f"unknown sigma schedule {kind!r}")
    return _SCHEDULE_FACTORIES[kind](**spec)


_REGISTRY = {cls.__name__: cls for cls in (
    MPPIConfig, MultirotorParams, WholeBodyParams, WholeBodyCostParams, WholeBodyMPPIParams,
    FlightGains, FwAeroParams, FwVehicleParams, LiftDragParams, DepthCameraParams,
    MappedFlightConfig, OccupancyParams, LidarParams, FwMPPIParams, MappedMPPIParams,
    GimbalParams, GeotagParams, GpsParams, WholeBodyLoopConfig, DroneMPPIParams, LoopConfig,
    ArmCostParams, ArmMPPIParams, ArmLoopConfig, GraspableParams, ContactParams,
    WorldPrimitives, MultirotorCostParams, MultirotorMPPIParams, GroundContactParams, LeeGains,
    WindParams, WindField, MissionConfig, ImuParams, BarometerParams, MagnetometerParams,
    OdometryParams, OpticalFlowParams, HilConfig,
)}


def register(cls):
    """Register an additional dataclass for deserialization."""
    _REGISTRY[cls.__name__] = cls
    return cls


def from_dict(data: Any) -> Any:
    """Inverse of :func:`to_dict`: arrays come back as NumPy arrays,
    schedules from their factories, dataclasses as this package's classes
    (list fields of a tuple type as tuples)."""
    if isinstance(data, dict):
        if "__ndarray__" in data:
            return np.asarray(data["__ndarray__"], dtype=data["dtype"])
        if "__schedule__" in data:
            return _build_schedule(data["__schedule__"])
        if "__dataclass__" in data:
            name = data["__dataclass__"]
            cls = _REGISTRY.get(name)
            if cls is None:
                raise ValueError(f"unregistered config dataclass {name!r}: no counterpart "
                                 "in this package")
            kwargs = {k: from_dict(v) for k, v in data.items() if k != "__dataclass__"}
            for f in dataclasses.fields(cls):
                if isinstance(kwargs.get(f.name), list) and "tuple" in str(f.type).lower():
                    kwargs[f.name] = tuple(tuple(x) if isinstance(x, list) else x
                                           for x in kwargs[f.name])
            return cls(**kwargs)
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_dict(x) for x in data]
    return data


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(path: str) -> Any:
    with open(path) as f:
        return from_dict(json.load(f))


def replace_path(cfg: Any, dotted: str, value: Any) -> Any:
    """Functional update of a nested field: replace_path(c, 'mppi.lam', 0.05)."""
    head, _, rest = dotted.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(cfg, **{head: replace_path(getattr(cfg, head), rest, value)})


@register
@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment description."""

    solver: WholeBodyMPPIParams = field(default_factory=WholeBodyMPPIParams)
    gains: FlightGains = field(default_factory=FlightGains)
    seed: int = 0
    n_control_steps: int = 1000
