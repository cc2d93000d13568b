"""Stage "one control period of the frozen-coefficient plant": ``substeps``
1 kHz physics steps of each of B vehicles (octorotor with rotor lag,
7-joint arm, backstepping position controller), with the arm's dynamics
coefficients frozen over the period (gravity-linear and
velocity-quadratic, the mass-matrix inverse given).

Per vehicle and substep (J = 7 joints, R = 8 rotors; ``common.py`` for
the unit costs):

==========================================  ==============================
term                                        operations
==========================================  ==============================
gravity direction in the body, a0           10
bias torque g_tau a0 + qd^T C qd            2 J * 3 + 2 J^3 + 2 J^2
qdd = M^-1 (tau - bias)                     J + 2 J^2
arm gravity moment on the base, g_n a0      18
integrate q, qdot; joint stops              4 J + 4 J
backstepping position controller            200
allocation to rotor speeds                  2 * 4 * R + R * (1
                                            transcendental + 2)
rotor lag                                   3 R
rotor wrench                                R + 2 * 4 * R
rigid body: rotation of the quaternion,     30 + 20 + 30 + 3 transcendental
forces, Euler's equations, quaternion       + 30 + 12
integration with its normalisation,
velocity and position
==========================================  ==============================

Bytes per vehicle and period: the plant state (46 floats) read and
written once, the frozen coefficients (g_tau 3 J, C J^3, g_n 9, M^-1 J^2)
and the commands (4 base, J arm torques) read once.
"""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_work_common",
                                               Path(__file__).with_name("common.py"))
c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(c)

KERNELS = ("plant_tick_kernel",)
J, R = 7, 8
STATE = 3 + 4 + 3 + 3 + R + J + J + 11


def per_substep() -> int:
    t = c.TRANSCENDENTAL
    return (10 + (2 * J * 3 + 2 * J ** 3 + 2 * J * J) + (J + 2 * J * J) + 18 + 8 * J + 200
            + (2 * 4 * R + R * (t + 2)) + 3 * R + (R + 2 * 4 * R)
            + (30 + 20 + 30 + 3 * t + 30 + 12))


def work(shape: dict) -> list:
    b, n = shape["B"], shape["substeps"]
    flops = b * n * per_substep()
    nbytes = b * c.FLOAT * (2 * STATE + 3 * J + J ** 3 + 9 + J * J + 4 + J)
    return [{"flops": flops, "bytes": nbytes}]
