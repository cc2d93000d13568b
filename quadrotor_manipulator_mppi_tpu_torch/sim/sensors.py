"""Sensor models: the ADIS16448 IMU, GPS, barometer, magnetometer,
odometry, optical flow and the planar lidar.

Port of the JAX package's ``sim/sensors.py`` (the RotorS sensor plugins):
the IMU's white measurement noise (density / sqrt(dt)) plus a first-order
Gauss-Markov bias walk with the exact discrete covariance and a turn-on
bias; a flat-earth GPS; the ISA barometer; the body-frame magnetometer;
odometry with per-field noise and a fixed-step delay ring; the PX4Flow-class
optical-flow rates; and the lidar, a planar multi-beam range scanner
against the analytic scene (a ground plane and sphere obstacles).

The noise is explicit: each noisy function takes its standard normals
``noise``, or a ``(seed, step)`` pair and draws them from the Philox stream
of ``ops/sampling`` (:func:`normals`) under that key and counter word, so a
closed loop on the card keeps both in its carry as int64 device tensors and
a resumed loop continues the exact stream.  Where the JAX package splits
its key, the port takes the draws in the order of the split's sub-keys
(each function names its layout), so a test can feed the JAX draws to both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import sampling
from ..utils.device import device_const

Tensor = torch.Tensor


_PI = float(np.pi)


def normals(n: int, seed: Tensor, step: Tensor) -> Tensor:
    """(n,) standard normals of draw ``step`` under the key ``seed`` (both
    int64 device tensors): the Philox stream of
    ``ops/sampling.philox_normals``, one sample per value."""
    return sampling.philox_normals(seed, step, n, 1, 1, seed.device).reshape(-1)


def _draws(n: int, noise: Optional[Tensor], seed: Optional[Tensor], step: Optional[Tensor],
           like: Tensor) -> Tensor:
    """``noise`` flattened, or the ``(seed, step)`` pair's ``n`` normals."""
    if noise is None:
        if seed is None:
            raise ValueError("pass standard normals (noise=) or a (seed, step) pair")
        noise = normals(n, seed, step)
    noise = noise.reshape(-1).to(like.dtype)
    if noise.numel() != n:
        raise ValueError(f"expected {n} standard normals, got {noise.numel()}")
    return noise


@dataclass(frozen=True)
class ImuParams:
    """ADIS16448 defaults (the reference's ``gazebo_imu_plugin.h``)."""

    gyro_noise_density: float = 2.0 * 35.0 / 3600.0 / 180.0 * _PI
    gyro_random_walk: float = 2.0 * 4.0 / 3600.0 / 180.0 * _PI
    gyro_bias_corr_time: float = 1.0e3
    gyro_turn_on_bias_sigma: float = 0.5 / 180.0 * _PI
    accel_noise_density: float = 2.0 * 2.0e-3
    accel_random_walk: float = 2.0 * 3.0e-3
    accel_bias_corr_time: float = 300.0
    accel_turn_on_bias_sigma: float = 20.0e-3 * 9.8


class ImuState(NamedTuple):
    gyro_bias: Tensor      # (3,)
    accel_bias: Tensor     # (3,)
    gyro_turn_on: Tensor   # (3,) constant per episode
    accel_turn_on: Tensor  # (3,)


def init_imu(params: ImuParams, noise: Optional[Tensor] = None, seed: Optional[Tensor] = None,
             step: Optional[Tensor] = None, dtype=torch.float32, device=None) -> ImuState:
    """Zero walking biases and the turn-on biases from 6 standard normals
    (gyro xyz, then accel xyz: the JAX split's two sub-keys)."""
    like = torch.zeros(3, dtype=dtype, device=device if seed is None else seed.device)
    z = _draws(6, noise, seed, step, like)
    return ImuState(gyro_bias=like.clone(), accel_bias=like.clone(),
                    gyro_turn_on=params.gyro_turn_on_bias_sigma * z[:3],
                    accel_turn_on=params.accel_turn_on_bias_sigma * z[3:])


def _f32(x: float) -> float:
    """A host constant rounded to float32, as the JAX package computes it."""
    return float(np.float32(x))


def imu_measure(params: ImuParams, state: ImuState, true_accel: Tensor, true_gyro: Tensor,
                dt: float, noise: Optional[Tensor] = None, seed: Optional[Tensor] = None,
                step: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, ImuState]:
    """(accel_meas, gyro_meas, new state): the plugin's AddNoise.  Twelve
    standard normals (4, 3), in the JAX split's order: the gyro bias walk,
    the accel bias walk, the gyro white noise, the accel white noise."""
    z = _draws(12, noise, seed, step, true_accel).reshape(4, 3)

    def gm_step(bias, sigma_b, tau, zi):
        sigma_d = np.sqrt(np.float32(-(sigma_b ** 2) * tau / 2.0)
                          * (np.exp(np.float32(-2.0 * dt / tau)) - np.float32(1.0)))
        phi = np.exp(np.float32(-dt / tau))
        return float(phi) * bias + float(sigma_d) * zi

    gyro_bias = gm_step(state.gyro_bias, params.gyro_random_walk, params.gyro_bias_corr_time,
                        z[0])
    accel_bias = gm_step(state.accel_bias, params.accel_random_walk,
                         params.accel_bias_corr_time, z[1])
    sigma_g_d = _f32(np.float32(params.gyro_noise_density) / np.sqrt(np.float32(dt)))
    sigma_a_d = _f32(np.float32(params.accel_noise_density) / np.sqrt(np.float32(dt)))
    gyro = true_gyro + gyro_bias + state.gyro_turn_on + sigma_g_d * z[2]
    accel = true_accel + accel_bias + state.accel_turn_on + sigma_a_d * z[3]
    return accel, gyro, state._replace(gyro_bias=gyro_bias, accel_bias=accel_bias)


@dataclass(frozen=True)
class GpsParams:
    """Flat-earth GPS: horizontal and vertical gaussian noise at a reduced
    rate."""

    horizontal_noise: float = 0.0
    vertical_noise: float = 0.0
    decimation: int = 10  # sensor ticks per GPS fix (e.g. 1 kHz -> 100 Hz)


def gps_measure(params: GpsParams, pos: Tensor, noise: Optional[Tensor] = None,
                seed: Optional[Tensor] = None, step: Optional[Tensor] = None) -> Tensor:
    """A fix: ``pos`` plus noise from 3 standard normals (horizontal x, y,
    then vertical: the JAX split's two sub-keys).  ``pos`` (..., 3) gives
    one fix per row, from 3 normals per row, row after row."""
    z = _draws(pos.numel(), noise, seed, step, pos).reshape(pos.shape)
    return pos + torch.cat([params.horizontal_noise * z[..., :2],
                            params.vertical_noise * z[..., 2:]], dim=-1)


@dataclass(frozen=True)
class BarometerParams:
    """Pressure altitude: ISA pressure with gaussian noise, reported as the
    pressure and the altitude derived from it."""

    noise_std_pa: float = 0.0
    p0: float = 101325.0  # sea-level pressure [Pa]
    scale_height: float = 8434.0  # [m] isothermal approx


def barometer_measure(params: BarometerParams, alt: Tensor, noise: Optional[Tensor] = None,
                      seed: Optional[Tensor] = None, step: Optional[Tensor] = None):
    """(pressure, altitude) from one standard normal."""
    z = _draws(1, noise, seed, step, alt)[0]
    p = params.p0 * torch.exp(-alt / params.scale_height) + params.noise_std_pa * z
    return p, -params.scale_height * torch.log(p / params.p0)


@dataclass(frozen=True)
class MagnetometerParams:
    """Body-frame magnetic field: a fixed world reference field rotated into
    the body, plus noise."""

    ref_field: tuple = (0.21523, 0.0, 0.42741)  # gauss
    noise_std: float = 0.0


def magnetometer_measure(params: MagnetometerParams, body_rot: Tensor,
                         noise: Optional[Tensor] = None, seed: Optional[Tensor] = None,
                         step: Optional[Tensor] = None) -> Tensor:
    """R^T h_world plus noise from 3 standard normals."""
    z = _draws(3, noise, seed, step, body_rot)
    h_body = torch.einsum("...ji,j->...i", body_rot, device_const(params.ref_field, body_rot))
    return h_body + params.noise_std * z


@dataclass(frozen=True)
class OdometryParams:
    """Zero defaults = the ground-truth fixture configuration."""

    pos_noise: float = 0.0
    vel_noise: float = 0.0
    att_noise: float = 0.0      # applied to rpy-equivalent small angles
    rate_noise: float = 0.0
    delay_steps: int = 0        # measurement delay in sensor ticks


class OdometryState(NamedTuple):
    """Ring buffer of delayed measurements (pos, vel, rpy, omega)."""

    buffer: Tuple[Tensor, Tensor, Tensor, Tensor]  # each (D+1, 3)
    head: Tensor                                   # () int32 ring index


def init_odometry(params: OdometryParams, pos: Tensor, dtype=torch.float32) -> OdometryState:
    d = params.delay_steps + 1
    zeros = torch.zeros((d, 3), dtype=dtype, device=pos.device)
    return OdometryState(buffer=(pos.to(dtype).expand(d, 3).clone(), zeros, zeros.clone(),
                                 zeros.clone()),
                         head=torch.zeros((), dtype=torch.int32, device=pos.device))


def odometry_measure(params: OdometryParams, state: OdometryState, pos: Tensor, vel: Tensor,
                     rpy: Tensor, omega: Tensor, noise: Optional[Tensor] = None,
                     seed: Optional[Tensor] = None, step: Optional[Tensor] = None):
    """Push the true state, pop the delayed one, add per-field noise from
    twelve standard normals (4, 3): pos, vel, rpy, omega, the JAX split's
    order (a field with zero noise ignores its row).  Returns ((pos, vel,
    rpy, omega), new state)."""
    sigmas = (params.pos_noise, params.vel_noise, params.att_noise, params.rate_noise)
    z = _draws(12, noise, seed, step, pos).reshape(4, 3) if any(sigmas) else None
    d = params.delay_steps + 1
    head = state.head.long().reshape(1)
    new_bufs = tuple(b.index_copy(0, head, v.to(b.dtype)[None])
                     for b, v in zip(state.buffer, (pos, vel, rpy, omega)))
    tail = (state.head + 1) % d  # the oldest entry: the delayed measurement
    meas = tuple(b.index_select(0, tail.long().reshape(1))[0] + (sigma * z[i] if sigma else 0.0)
                 for i, (b, sigma) in enumerate(zip(new_bufs, sigmas)))
    return meas, OdometryState(buffer=new_bufs, head=tail)


@dataclass(frozen=True)
class LidarParams:
    """Planar multi-beam range scanner."""

    n_beams: int = 16
    fov: float = 2.0 * np.pi      # full scan [rad]
    max_range: float = 30.0
    noise: float = 0.01           # [m]
    pitch: float = 0.0            # beam elevation from the body xy-plane [rad]


def lidar_directions(params: LidarParams, like: Tensor) -> Tensor:
    """(n_beams, 3) unit beam directions in the BODY frame, in ``like``'s
    dtype and on its device: ``endpoint = pos + (rot @ dir) * range``."""
    az = np.linspace(0.0, params.fov, params.n_beams, endpoint=False).astype(np.float32)
    cp, sp = np.cos(params.pitch), np.sin(params.pitch)
    dirs = np.stack([cp * np.cos(az), cp * np.sin(az), np.full_like(az, sp)], axis=-1)
    return device_const(dirs.astype(np.float32), like)


def lidar_noise(params: LidarParams, seed: Tensor, step: Tensor) -> Tensor:
    """(n_beams,) standard normals of draw ``step`` under the key ``seed``
    (both (1,) int64 device tensors), one per beam (:func:`normals`)."""
    return normals(params.n_beams, seed, step)


def lidar_measure(
    params: LidarParams,
    pos: Tensor,
    rot: Tensor,                              # (3, 3) body -> world
    ground_z: float = 0.0,
    sphere_centers: Optional[Tensor] = None,  # (N, 3)
    sphere_radii: Optional[Tensor] = None,    # (N,)
    noise: Optional[Tensor] = None,           # (n_beams,) standard normals
    seed: Optional[Tensor] = None,            # (1,) int64 Philox key ...
    step: Optional[Tensor] = None,            # ... and (1,) int64 draw counter
) -> Tensor:
    """(n_beams,) ranges: the least hit distance over the scene primitives,
    plus ``params.noise`` times the standard normals ``noise``, or those
    :func:`lidar_noise` draws for ``(seed, step)`` (no noise when neither is
    given), clamped to [0, max_range]."""
    dirs_w = torch.einsum("ij,bj->bi", rot, lidar_directions(params, pos))
    rng = torch.full((params.n_beams,), params.max_range, dtype=pos.dtype, device=pos.device)

    # Ground plane z = ground_z: t = (ground_z - z0) / dz for dz < 0.
    dz = dirs_w[:, 2]
    t_ground = (ground_z - pos[2]) / torch.where(dz.abs() < 1e-9, -1e-9, dz)
    rng = torch.minimum(rng, torch.where(t_ground > 0.0, t_ground, params.max_range))

    if sphere_centers is not None and sphere_radii is not None:
        oc = pos[None, None, :] - sphere_centers[None, :, :]   # (1, N, 3)
        d = dirs_w[:, None, :]                                 # (B, 1, 3)
        b = torch.sum(d * oc, dim=-1)                          # (B, N)
        c = torch.sum(oc * oc, dim=-1) - sphere_radii[None, :] ** 2
        disc = b * b - c
        t_hit = -b - torch.sqrt(disc.clamp(min=0.0))
        valid = (disc > 0.0) & (t_hit > 0.0)
        t_sph = torch.where(valid, t_hit, params.max_range)
        rng = torch.minimum(rng, torch.amin(t_sph, dim=-1))

    if noise is None and seed is not None:
        noise = lidar_noise(params, seed, step)
    if params.noise > 0.0 and noise is not None:
        rng = rng + params.noise * noise
    return torch.clamp(rng, 0.0, params.max_range)


@dataclass(frozen=True)
class OpticalFlowParams:
    """Downward-looking flow sensor: angular flow rates from the
    translational velocity over the ground height plus the rotational
    self-motion (the PX4Flow measurement model)."""

    noise: float = 0.01           # [rad/s]
    min_height: float = 0.3       # below this the flow saturates
    max_flow: float = 4.5         # [rad/s] sensor saturation


def optical_flow_measure(params: OpticalFlowParams, vel_body: Tensor, omega_body: Tensor,
                         height: Tensor, noise: Optional[Tensor] = None,
                         seed: Optional[Tensor] = None, step: Optional[Tensor] = None) -> Tensor:
    """(2,) flow rates about the camera x and y axes [rad/s], from two
    standard normals, clipped to the saturation."""
    z = _draws(2, noise, seed, step, vel_body)
    h = height.clamp(min=params.min_height)
    flow = torch.stack([vel_body[0] / h - omega_body[1], vel_body[1] / h + omega_body[0]])
    return (flow + params.noise * z).clamp(-params.max_flow, params.max_flow)
