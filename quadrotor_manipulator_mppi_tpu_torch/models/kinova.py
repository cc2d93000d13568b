"""Kinova j2s7s300 7-DoF arm model constants.

Physical parameters of the reference robot description
(``aerial_manipulator_gpu.urdf``): joint origins/axes/limits, the fixed
world->arm-base mount (rpy=(pi,0,0): the arm hangs inverted under the
drone), the link_7->end_effector fixed frame, and per-link inertials.
A copy of the JAX package's constants, so the port needs nothing from it.
"""

from __future__ import annotations

import numpy as np

from .chain import REVOLUTE, ChainSpec, build_chain
from .rigid_body import InertialParams

PI = float(np.pi)
TWO_PI = 2.0 * PI

N_JOINTS = 7

# Joint origins (parent-frame xyz / rpy before the joint axis), joints 1..7.
_ORIGINS_XYZ = [
    [0.0, 0.0, 0.15675],
    [0.0, 0.0016, -0.11875],
    [0.0, -0.205, 0.0],
    [0.0, 0.0, -0.205],
    [0.0, 0.2073, -0.0114],
    [0.0, 0.0, -0.10375],
    [0.0, 0.10375, 0.0],
]
_ORIGINS_RPY = [
    [0.0, PI, 0.0],
    [-PI / 2, 0.0, PI],
    [-PI / 2, 0.0, 0.0],
    [PI / 2, 0.0, PI],
    [-PI / 2, 0.0, PI],
    [PI / 2, 0.0, PI],
    [-PI / 2, 0.0, PI],
]

# All seven joints rotate about the local +z axis.
_AXES = [[0.0, 0.0, 1.0]] * N_JOINTS

JOINT_LOWER = np.array([-TWO_PI, 0.8203047484373349, -TWO_PI, 0.5235987755982988,
                        -TWO_PI, 1.1344640137963142, -TWO_PI])
JOINT_UPPER = np.array([TWO_PI, 5.462880558742252, TWO_PI, 5.759586531581287,
                        TWO_PI, 5.148721293383272, TWO_PI])
JOINT_VELOCITY = np.array([0.6283185307179586] * 4 + [0.8377580409572781] * 3)
JOINT_EFFORT = np.array([40.0, 80.0, 40.0, 40.0, 20.0, 20.0, 20.0])

# Mid-range posture used by the reference's centering cost
# (``cost/joint_space_cost.py:15`` — note its values are for a different
# limit set; we derive the true mid-range of the unlimited joints as 0).
Q_CENTER = np.array([0.0, (JOINT_LOWER[1] + JOINT_UPPER[1]) / 2, 0.0,
                     (JOINT_LOWER[3] + JOINT_UPPER[3]) / 2, 0.0,
                     (JOINT_LOWER[5] + JOINT_UPPER[5]) / 2, 0.0])

# Home posture commanded by the reference arm node before MPPI engages
# (``scripts/kinova.py:136`` phase-1 target qtarget).
Q_HOME = np.array([1.57, 1.7, 0.0, 4.4, 0.0, 4.71, 0.0])


def chain(tip: str = "link_7") -> ChainSpec:
    """Arm kinematic chain rooted at the drone-body mount frame.

    ``tip='link_7'`` matches the reference FK configuration
    (``mppi_solver/mppi.py:86-88`` uses end_link='j2s7s300_link_7');
    ``tip='end_effector'`` appends the fixed EE frame
    (``aerial_manipulator_gpu.urdf:377-382``).
    """
    if tip == "link_7":
        tip_xyz, tip_rpy = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    elif tip == "end_effector":
        tip_xyz, tip_rpy = (0.0, 0.0, -0.16), (PI, 0.0, PI / 2)
    else:
        raise ValueError(f"unknown tip {tip!r}")
    return build_chain(
        origins_xyz=_ORIGINS_XYZ,
        origins_rpy=_ORIGINS_RPY,
        axes=_AXES,
        joint_types=[REVOLUTE] * N_JOINTS,
        lower=JOINT_LOWER,
        upper=JOINT_UPPER,
        velocity=JOINT_VELOCITY,
        effort=JOINT_EFFORT,
        pre_xyz=(0.0, 0.0, 0.0),
        pre_rpy=(PI, 0.0, 0.0),  # arm mounted inverted under the base
        tip_xyz=tip_xyz,
        tip_rpy=tip_rpy,
        joint_names=tuple(f"j2s7s300_joint_{i}" for i in range(1, 8)),
    )


def inertials() -> InertialParams:
    """Per-link mass / center-of-mass / rotational inertia (links 1..7),
    expressed in each joint's child-link frame, from the URDF inertial blocks.

    Link 7's values absorb the hand; finger links are fixed in the FK model
    (as in the reference URDF) and their small masses are neglected.
    """
    mass = np.array([0.7477, 0.8447, 0.8447, 0.6763, 0.463, 0.463, 0.99])
    com = np.array([
        [0.0, -0.002, -0.0605],
        [0.0, -0.103563213, 0.0],
        [0.0, 0.0, -0.1022447445],
        [0.0, 0.081, -0.0086],
        [0.0, 0.0028848942, -0.0541932613],
        [0.0, 0.0497208855, -0.0028562765],
        [0.0, 0.0, -0.06],
    ])

    def diag(ixx, iyy, izz):
        return np.diag([ixx, iyy, izz])

    inertia = np.stack([
        diag(0.00152031725204, 0.00152031725204, 0.00059816),
        diag(0.00247073761701, 0.000380115, 0.00247073761701),
        diag(0.00247073761701, 0.00247073761701, 0.000380115),
        diag(0.00142022431908, 0.000304335, 0.00142022431908),
        diag(0.0004321316048, 0.0004321316048, 9.26e-05),
        diag(0.0004321316048, 9.26e-05, 0.0004321316048),
        diag(0.000470248119, 0.000470248119, 0.000792),
    ])
    return InertialParams(mass=mass, com=com, inertia=inertia)
