"""HarrierD7 octorotor parameters and the reduced rollout state.

Only what the whole-body solve needs is ported so far: the vehicle
constants (mass, inertia, rotor set — the same fields as the JAX package,
so its configuration tree carries across unchanged) and
:class:`Multirotor12State`.  The plant dynamics arrive with the closed loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class MultirotorParams:
    mass: float = 14.7
    inertia: tuple = (1.57, 3.93, 2.59)
    n_rotors: int = 8
    motor_constant: float = 4.63e-4      # k_f [N s^2]
    moment_constant: float = 0.0173      # k_m [m]
    xlen: float = 0.534
    ylen: float = 0.574
    max_rotor_speed: float = 650.0
    time_constant_up: float = 0.0125
    time_constant_down: float = 0.025
    rotor_drag_coefficient: float = 8.06428e-5
    rolling_moment_coefficient: float = 1e-6
    ground_z: float = 0.0
    # Allocation sign rows (roll, pitch, yaw) per rotor.
    roll_signs: tuple = (-1, 1, 1, -1, -1, 1, 1, -1)
    pitch_signs: tuple = (-1, -1, 1, 1, -1, -1, 1, 1)
    yaw_signs: tuple = (1, -1, 1, -1, -1, 1, -1, 1)
    # Alternative per-rotor geometry (angle, arm, k_f, k_m, direction).
    rotor_config: tuple = ()


class Multirotor12State(NamedTuple):
    """Reduced state for sampled rollouts: (roll, pitch, yaw) attitude."""

    pos: torch.Tensor    # (…, 3)
    rpy: torch.Tensor    # (…, 3)
    vel: torch.Tensor    # (…, 3) world
    omega: torch.Tensor  # (…, 3) body
