"""Mission state machine: takeoff -> gear -> task -> land.

Port of the JAX package's ``sim/scenario.py`` (the plant plugin's
operational logic in the reference's ``controller.cpp``): takeoff complete
at z > 1.95 with |zdot| < 3e-2, then the landing gear retracts; the Land
command descends, extends the gear and cuts the motors below z < 0.5; the
gripper is a first-order aperture with a rigid payload attach.

Every transition is a masked tensor expression with no data-dependent
control flow, so the machine runs inside a captured CUDA graph: the phase
is an int32 tensor, ``land_cmd`` and ``payload_attached`` bool tensors, and
the motors-on flag comes back as a bool tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..utils.device import device_const
from . import flight_control as fc

Tensor = torch.Tensor

# Mission phases.
IDLE = 0
TAKEOFF = 1
CRUISE = 2      # gear retracted, task control enabled
LANDING = 3
LANDED = 4

# Reference thresholds (controller.cpp).
TAKEOFF_Z = 1.95
TAKEOFF_ZDOT = 3e-2
MOTOR_CUT_Z = 0.5
GEAR_RATE = 2.0           # gear deploy fraction per second (sim choice)
GRIPPER_RATE = 4.0


@dataclass(frozen=True)
class MissionConfig:
    hover_target: tuple = (0.0, 0.0, 2.1)  # launch file z_desired
    land_descent_rate: float = 0.4          # m/s commanded descent
    payload_mass: float = 0.5               # pick_weight graspable mass


class MissionState(NamedTuple):
    phase: Tensor             # () int32
    gear: Tensor              # () in [0, 1]: 1 = extended
    gripper: Tensor           # () in [0, 1]: 1 = closed
    gripper_cmd: Tensor       # () target aperture
    payload_attached: Tensor  # () bool
    land_cmd: Tensor          # () bool: the external Land request
    land_z: Tensor            # () commanded altitude while landing


def init_mission(dtype=torch.float32, device=None) -> MissionState:
    return MissionState(
        phase=torch.full((), TAKEOFF, dtype=torch.int32, device=device),
        gear=torch.ones((), dtype=dtype, device=device),
        gripper=torch.zeros((), dtype=dtype, device=device),
        gripper_cmd=torch.zeros((), dtype=dtype, device=device),
        payload_attached=torch.zeros((), dtype=torch.bool, device=device),
        land_cmd=torch.zeros((), dtype=torch.bool, device=device),
        land_z=torch.full((), 2.1, dtype=dtype, device=device),
    )


def mission_step(cfg: MissionConfig, state: MissionState, pos: Tensor, vel: Tensor,
                 dt: float) -> Tuple[MissionState, fc.FlightSetpoint, Tensor]:
    """Advance the machine one control tick: (new state, flight setpoint,
    motors-on flag)."""
    dtype = pos.dtype
    z, zdot = pos[..., 2], vel[..., 2]
    phase = state.phase

    # Transitions.
    takeoff_done = (phase == TAKEOFF) & (z > TAKEOFF_Z) & (zdot.abs() < TAKEOFF_ZDOT)
    phase = torch.where(takeoff_done, CRUISE, phase)
    start_land = state.land_cmd & ((phase == CRUISE) | (phase == TAKEOFF))
    phase = torch.where(start_land, LANDING, phase)
    touched_down = (phase == LANDING) & (z < MOTOR_CUT_Z)
    phase = torch.where(touched_down, LANDED, phase)

    # Gear: retracted in cruise, extended otherwise.
    gear_target = torch.where(phase == CRUISE, 0.0, 1.0).to(dtype)
    gear = state.gear + (gear_target - state.gear).clamp(-GEAR_RATE * dt, GEAR_RATE * dt)

    # Gripper first-order aperture and payload attach.
    gripper = state.gripper + (state.gripper_cmd - state.gripper).clamp(-GRIPPER_RATE * dt,
                                                                        GRIPPER_RATE * dt)
    payload = state.payload_attached | (gripper > 0.95)

    # Setpoint.
    hover = device_const(cfg.hover_target, pos)
    land_z = torch.where(phase == LANDING,
                         (state.land_z - cfg.land_descent_rate * dt).clamp(min=0.0), z).to(dtype)
    sp_pos = torch.where(phase == LANDING, torch.stack([pos[..., 0], pos[..., 1], land_z], -1),
                         hover)
    zero = torch.zeros((), dtype=dtype, device=pos.device)
    setpoint = fc.FlightSetpoint(pos=sp_pos, vel=torch.zeros(3, dtype=dtype, device=pos.device),
                                 yaw=zero, yaw_rate=zero)
    new = MissionState(phase=phase, gear=gear, gripper=gripper, gripper_cmd=state.gripper_cmd,
                       payload_attached=payload, land_cmd=state.land_cmd, land_z=land_z)
    return new, setpoint, phase != LANDED


def payload_mass(cfg: MissionConfig, state: MissionState, dtype=torch.float32) -> Tensor:
    """Extra plant mass while the payload is grasped."""
    return torch.where(state.payload_attached, cfg.payload_mass, 0.0).to(dtype)
