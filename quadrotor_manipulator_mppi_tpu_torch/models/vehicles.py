"""Stock MAV vehicle library — the ``rotors_description`` / resource-yaml
analog.

A copy of the JAX package's ``models/vehicles.py`` (pure Python; that
package's ``__init__`` imports JAX, so the port keeps its own copy), with
the port's ``MultirotorParams`` and ``LeeGains``.

Each preset transcribes a RotorS vehicle's parameters
(the reference's ``rotors_simulator/rotors_gazebo/resource/<name>.yaml``
for mass/inertia/rotor configuration and
``rotors_description/urdf/<name>.xacro`` for the motor-dynamics constants)
into a :class:`~.multirotor.MultirotorParams` whose allocation matrix is
built from rotor geometry per ``rotors_control/common.h:79-97``.  All
presets run through the same plant (``multirotor.step``), controllers
(Lee / backstepping / PID) and MPPI solvers as the HarrierD7.

    from quadrotor_manipulator_mppi_tpu_torch.models import vehicles
    veh = vehicles.get("firefly")
"""

from __future__ import annotations

import math

from .multirotor import MultirotorParams

_PI = math.pi

# Motor-dynamics constants shared by the AscTec-class stock vehicles
# (firefly.xacro:37-43; identical lines in hummingbird/pelican/iris xacros).
_STOCK_MOTOR = dict(
    max_rotor_speed=838.0,
    time_constant_up=0.0125,
    time_constant_down=0.025,
    rotor_drag_coefficient=8.06428e-5,
    rolling_moment_coefficient=1e-6,
)


def _hex_config(arm: float, kf: float, km: float) -> tuple:
    """The RotorS hexacopter layout (firefly.yaml rotor_configuration)."""
    angles = [_PI / 6, _PI / 2, 5 * _PI / 6, -5 * _PI / 6, -_PI / 2, -_PI / 6]
    dirs = [1.0, -1.0, 1.0, -1.0, 1.0, -1.0]
    return tuple((a, arm, kf, km, d) for a, d in zip(angles, dirs))


def _quad_plus_config(arm: float, kf: float, km: float) -> tuple:
    """Plus-configuration quad (hummingbird/pelican yaml)."""
    angles = [0.0, _PI / 2, _PI, -_PI / 2]
    dirs = [-1.0, 1.0, -1.0, 1.0]
    return tuple((a, arm, kf, km, d) for a, d in zip(angles, dirs))


def harrier() -> MultirotorParams:
    """The aerial-manipulation octorotor (the repo default)."""
    return MultirotorParams()


def firefly() -> MultirotorParams:
    """AscTec Firefly hexacopter (firefly.yaml:1-15)."""
    return MultirotorParams(
        mass=1.56779,
        inertia=(0.0347563, 0.0458929, 0.0977),
        n_rotors=6,
        rotor_config=_hex_config(0.215, 8.54858e-6, 1.6e-2),
        **_STOCK_MOTOR,
    )


def hummingbird() -> MultirotorParams:
    """AscTec Hummingbird quad (hummingbird.yaml:1-13)."""
    return MultirotorParams(
        mass=0.716,
        inertia=(0.007, 0.007, 0.012),
        n_rotors=4,
        rotor_config=_quad_plus_config(0.17, 8.54858e-6, 1.6e-2),
        **_STOCK_MOTOR,
    )


def pelican() -> MultirotorParams:
    """AscTec Pelican quad (pelican.yaml:1-13)."""
    return MultirotorParams(
        mass=1.0,
        inertia=(0.01, 0.01, 0.02),
        n_rotors=4,
        rotor_config=_quad_plus_config(0.21, 9.9865e-6, 1.6e-2),
        **_STOCK_MOTOR,
    )


def iris() -> MultirotorParams:
    """3DR Iris quad, asymmetric X layout (iris.yaml:1-13)."""
    kf, km = 8.54858e-6, 1.6e-2
    cfg = (
        (-0.533708, 0.255539, kf, km, 1.0),
        (2.565218, 0.238537, kf, km, 1.0),
        (0.533708, 0.255539, kf, km, -1.0),
        (-2.565218, 0.238537, kf, km, -1.0),
    )
    return MultirotorParams(
        mass=1.52,
        inertia=(0.0347563, 0.0458929, 0.0977),
        n_rotors=4,
        rotor_config=cfg,
        **_STOCK_MOTOR,
    )


def neo11() -> MultirotorParams:
    """Neo11 hexacopter (neo11.yaml:1-15)."""
    return MultirotorParams(
        mass=3.42,
        inertia=(0.0608, 0.0688, 0.1489),
        n_rotors=6,
        rotor_config=_hex_config(0.2895, 1.269e-5, 1.6754e-2),
        **_STOCK_MOTOR,
    )


def ardrone() -> MultirotorParams:
    """Parrot ARDrone X-quad (ardrone.yaml:1-13)."""
    kf, km = 8.54858e-6, 1.6e-2
    cfg = (
        (-0.78539, 0.09, kf, km, 1.0),
        (2.35619, 0.09, kf, km, 1.0),
        (0.78539, 0.09, kf, km, -1.0),
        (-2.35619, 0.09, kf, km, -1.0),
    )
    return MultirotorParams(
        mass=1.52,
        inertia=(0.0347563, 0.0458929, 0.0977),
        n_rotors=4,
        rotor_config=cfg,
        **_STOCK_MOTOR,
    )


_REGISTRY = {
    "harrier": harrier,
    "firefly": firefly,
    "hummingbird": hummingbird,
    "pelican": pelican,
    "iris": iris,
    "neo11": neo11,
    "ardrone": ardrone,
}


def names() -> list:
    return sorted(_REGISTRY)


def get(name: str) -> MultirotorParams:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown vehicle {name!r}; available: {names()}") from None


# Per-vehicle Lee-controller gains, transcribed verbatim from the reference's
# ``rotors_gazebo/resource/lee_controller_<name>.yaml`` (the controller
# divides position/velocity gains by mass and attitude/rate gains by inertia
# internally, exactly as the reference does, so the yaml values apply
# unscaled).  (position, velocity, attitude, angular_rate) per axis.
_LEE_YAML = {
    "firefly": ((6, 6, 6), (4.7, 4.7, 4.7), (3, 3, 0.15), (0.52, 0.52, 0.18)),
    "hummingbird": ((4, 4, 4), (2.2, 2.2, 2.2), (0.7, 0.7, 0.035),
                    (0.1, 0.1, 0.025)),
    "pelican": ((4, 4, 4), (2.7, 2.7, 2.7), (1, 1, 0.035), (0.22, 0.22, 0.01)),
    "iris": ((6, 6, 6), (4.7, 4.7, 4.7), (2, 3, 0.15), (0.4, 0.52, 0.18)),
    "neo11": ((8, 8, 17), (6, 6, 10), (4, 4, 2), (0.7, 0.7, 0.7)),
    "ardrone": ((6, 6, 6), (4.7, 4.7, 4.7), (2, 2.3, 0.15), (0.4, 0.52, 0.18)),
}


def lee_gains(name: str):
    """Reference Lee gains for a stock vehicle (Harrier uses the repo's own
    rescaled tuning, sim/lee_controller.LeeGains defaults)."""
    from ..sim.lee_controller import LeeGains

    if name == "harrier" or name not in _LEE_YAML:
        return LeeGains()
    p, v, a, w = _LEE_YAML[name]
    return LeeGains(position=p, velocity=v, attitude=a, angular_rate=w)
