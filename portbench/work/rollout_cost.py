"""Stage "rollout and cost": per sample, draw the noise, roll the base and
the arm out over the horizon, run the 7-joint forward kinematics at every
step and sum the cost stack into S.

Counted per (scenario, sample, horizon step), in the cheapest sequential
form (each closed-loop axis a 2-state linear recurrence, never an (H, H)
operator), see ``common.py`` for the unit costs:

====================================  ======================================
term                                  operations
====================================  ======================================
draw A normals                        A * DRAW
v = u_prev + sigma * z                2 A
arm: qdot += a dt, q += qdot dt       4 J
joint stops on q for the FK           2 J
attitude mode: rotor lag on thrust    3
attitude mode: 3 PD axes              3 * 10 (x' = A x + B u, 2 states)
position mode: 3 position axes        3 * 10, the setpoint add 3, the
                                      accelerations 3 * 4, the small-angle
                                      attitude 3, its rates 6
attitude, position: quaternion of     6 transcendentals + 20
roll, pitch, yaw
attitude mode: thrust acceleration    11 (body z axis) + 5, velocity 6,
                                      position 6
wrench mode: rotor lag                4 * 3 (thrust and three torques)
wrench mode: body rates               3 * 5 (torque over inertia, the
                                      damped rate)
wrench mode: attitude                 3 transcendentals + 12 (the rate
                                      step's quaternion) + 28 (composed
                                      onto the attitude)
wrench mode: thrust acceleration      11 (body z axis) + 5, velocity 6,
                                      position 6
sphere obstacles, per obstacle        12 + 1 transcendental (the EE's
                                      distance to the centre, the squared
                                      penetration)
FK, per joint                         2 transcendentals (half-angle sin and
                                      cos) + 12 (joint rotation onto the
                                      fixed origin) + 28 (compose) + 30
                                      (rotate the link offset) + 3
stage costs                           EE position 6 + 2, orientation error
                                      28 + 1 transcendental + 8, base
                                      position 8, tilt 8, rates 5,
                                      velocity 5, soft joint limits J * (2
                                      transcendentals + 4), discount and
                                      sums 10
====================================  ======================================

Per sample once: the terminal pose and stopping-point costs, 60.  Bytes:
each input read once (the warm start H * A, 54 scalars of the
observation, 4 per obstacle), the costs S written once (K); the noise is
not an input, and intermediate buffers are not counted.
"""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_work_common",
                                               Path(__file__).with_name("common.py"))
c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(c)

KERNELS = ("wb_cost_kernel",)
J = 7
OBS_SCALARS = 54


def per_step(a: int, mode: str, n_obstacles: int = 0) -> int:
    t = c.TRANSCENDENTAL
    ops = a * c.DRAW + 2 * a + 4 * J + 2 * J
    if mode == "attitude":
        ops += 3 + 3 * 10 + (11 + 5) + 6 + 6
        ops += 6 * t + 20                               # quaternion of rpy
    elif mode == "position":
        ops += 3 * 10 + 3 + 3 * 4 + 3 + 6
        ops += 6 * t + 20                               # quaternion of rpy
    elif mode == "wrench":
        ops += 4 * 3 + 3 * 5 + (3 * t + 12 + 28) + (11 + 5) + 6 + 6
    else:
        raise ValueError(f"no work count for mode {mode!r}")
    ops += J * (2 * t + 12 + 28 + 30 + 3)               # forward kinematics
    ops += (6 + 2) + (28 + t + 8) + 8 + 8 + 5 + 5 + J * (2 * t + 4) + 10
    ops += n_obstacles * (12 + t)
    return ops


def work(shape: dict) -> list:
    b, k, h, a = shape["B"], shape["K"], shape["H"], shape["A"]
    n_obs = int(shape.get("n_obstacles", 0))
    flops = b * k * (h * per_step(a, shape["mode"], n_obs) + 60)
    nbytes = b * c.FLOAT * (h * a + OBS_SCALARS + 4 * n_obs + k)
    return [{"flops": flops, "bytes": nbytes}]
