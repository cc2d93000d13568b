"""Sensor models: the planar lidar.

Port of the lidar of the JAX package's ``sim/sensors.py``: a planar
multi-beam range scanner against the analytic scene (a ground plane and
sphere obstacles), the primitives the solver's obstacle costs use.  The
IMU, GPS, barometer, magnetometer, odometry and optical-flow models come
with a later slice of the port.

The range noise is explicit: :func:`lidar_measure` takes standard normals
``noise`` (n_beams,), or a ``(seed, step)`` pair and draws them from the
Philox stream of ``ops/sampling`` (:func:`lidar_noise`) under that key
and counter word, so a closed loop on the card keeps both in its carry as
int64 device tensors and a resumed loop continues the exact stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import sampling
from ..utils.device import device_const

Tensor = torch.Tensor


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
    (both (1,) int64 device tensors): the Philox stream of
    ``ops/sampling.philox_normals``, one sample per beam."""
    return sampling.philox_normals(seed, step, params.n_beams, 1, 1, seed.device).reshape(-1)


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
