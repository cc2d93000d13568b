"""Per-link inertial constants of a serial chain.

Only :class:`InertialParams` is ported so far: the whole-body rollout needs
link masses and centres of mass for the arm gravity moment.  The dynamics
(RNEA, mass matrix, frozen coefficients) arrive with the closed loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class InertialParams:
    """Host-side per-link inertial constants in the child-link frame:
    mass (J,), centre of mass (J, 3), rotational inertia about the centre
    of mass (J, 3, 3), as URDF ``<inertial>`` blocks give them."""

    mass: np.ndarray
    com: np.ndarray
    inertia: np.ndarray
