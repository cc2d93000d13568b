"""Wind and gust disturbance model.

Port of the JAX package's ``sim/wind.py`` (the RotorS wind plugin): a
constant mean wind plus periodic gusts with a sine ramp envelope and an
Ornstein-Uhlenbeck turbulence term (:func:`wind_velocity`), and the
plugin's custom static wind field, a regular x/y grid of terrain-following
columns, interpolated trilinearly (:class:`WindField`,
:func:`wind_field_velocity`).  Feed the result into ``multirotor.step``'s
``wind_world``.

The turbulence noise is explicit: :func:`wind_velocity` takes three
standard normals ``noise``, or a ``(seed, step)`` pair of int64 device
tensors and draws them from the Philox stream of ``ops/sampling`` under
that key and counter word (``sim.sensors.normals``), so a closed loop keeps both in its carry and a
resumed loop continues the exact stream.  The field's grids are device
constants and its lookups are gathers, so a captured step makes no host
copy and no host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import device_const
from .sensors import normals

Tensor = torch.Tensor


@dataclass(frozen=True)
class WindParams:
    mean_velocity: tuple = (0.0, 0.0, 0.0)       # [m/s] world frame
    gust_velocity: tuple = (0.0, 0.0, 0.0)       # peak gust [m/s]
    gust_start: float = 10.0                     # [s] (plugin default)
    gust_duration: float = 0.0                   # [s]
    gust_period: float = 1e9                     # [s] between gusts
    turbulence_sigma: float = 0.0                # OU stationary std [m/s]
    turbulence_tau: float = 1.0                  # OU correlation time [s]


class WindState(NamedTuple):
    turbulence: Tensor  # (3,) OU state


def init_wind(dtype=torch.float32, device=None) -> WindState:
    return WindState(turbulence=torch.zeros(3, dtype=dtype, device=device))


def fmod_floor(x: Tensor, y: float) -> Tensor:
    """x mod y with the sign of y, as ``jnp.mod``: the exact C remainder,
    then y added where its sign differs from y's."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def wind_velocity(params: WindParams, state: WindState, t, dt: float,
                  noise: Optional[Tensor] = None, seed: Optional[Tensor] = None,
                  step: Optional[Tensor] = None) -> Tuple[Tensor, WindState]:
    """Wind velocity at time ``t`` (world frame) and the advanced state.
    The turbulence takes ``noise`` (3,) standard normals, or draws them for
    ``(seed, step)`` (``sim.sensors.normals``); it needs one of them when
    ``params.turbulence_sigma > 0``."""
    turb = state.turbulence
    dtype = turb.dtype
    t = torch.as_tensor(t, dtype=dtype, device=turb.device)
    mean = device_const(params.mean_velocity, turb)
    gust = device_const(params.gust_velocity, turb)

    # Periodic gust window with a sine ramp envelope.
    phase = fmod_floor(t - params.gust_start, params.gust_period)
    in_gust = (t >= params.gust_start) & (phase < params.gust_duration)
    envelope = torch.where(in_gust,
                           torch.sin(math.pi * phase / max(params.gust_duration, 1e-6)),
                           0.0).to(dtype)

    # Ornstein-Uhlenbeck turbulence (exact discretization), the decay and
    # the drive rounded to float32 as the JAX package's are.
    if params.turbulence_sigma > 0.0:
        alpha = np.exp(np.float32(-dt / params.turbulence_tau))
        noise_std = np.float32(params.turbulence_sigma) * np.sqrt(np.float32(1.0) - alpha * alpha)
        if noise is None:
            if seed is None:
                raise ValueError("turbulence needs standard normals or a (seed, step) pair")
            noise = normals(3, seed, step)
        turb = float(alpha) * turb + float(noise_std) * noise.to(dtype)
    return mean + envelope * gust + turb, WindState(turbulence=turb)


@dataclass(frozen=True)
class WindField:
    """Static wind-field grid (the plugin's custom static field): a regular
    (min_x + i res_x, min_y + j res_y) horizontal grid whose vertical levels
    follow the terrain: each (x, y) column spans [bottom_z, top_z] with its
    levels at ``vertical_spacing_factors`` (monotone 0..1).  NumPy arrays:
    factors (nz,), bottom_z/top_z (ny, nx), u/v/w (nz, ny, nx)."""

    min_x: float
    min_y: float
    res_x: float
    res_y: float
    vertical_spacing_factors: np.ndarray  # (nz,)
    bottom_z: np.ndarray                  # (ny, nx)
    top_z: np.ndarray                     # (ny, nx)
    u: np.ndarray                         # (nz, ny, nx)
    v: np.ndarray
    w: np.ndarray

    @property
    def shape(self):
        return self.u.shape  # (nz, ny, nx)


def read_wind_field(path: str) -> WindField:
    """Load the plugin's text format (``ReadCustomWindField``): ``name:``
    tokens followed by whitespace-separated values."""
    fields: dict = {}
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    while i < len(tokens):
        name = tokens[i].rstrip(":")
        i += 1
        vals = []
        while i < len(tokens) and not tokens[i].endswith(":"):
            vals.append(float(tokens[i]))
            i += 1
        fields[name] = vals
    nx, ny = int(fields["n_x"][0]), int(fields["n_y"][0])
    nz = len(fields["vertical_spacing_factors"])
    return WindField(
        min_x=fields["min_x"][0],
        min_y=fields["min_y"][0],
        res_x=fields["res_x"][0],
        res_y=fields["res_y"][0],
        vertical_spacing_factors=np.asarray(fields["vertical_spacing_factors"], np.float32),
        bottom_z=np.asarray(fields["bottom_z"], np.float32).reshape(ny, nx),
        top_z=np.asarray(fields["top_z"], np.float32).reshape(ny, nx),
        u=np.asarray(fields["u"], np.float32).reshape(nz, ny, nx),
        v=np.asarray(fields["v"], np.float32).reshape(nz, ny, nx),
        w=np.asarray(fields["w"], np.float32).reshape(nz, ny, nx),
    )


def uniform_grid_field(wind_fn, *, x=(-10.0, 10.0, 11), y=(-10.0, 10.0, 11),
                       z=(0.0, 20.0, 9)) -> WindField:
    """A :class:`WindField` sampled from ``wind_fn(px, py, pz) -> (u, v,
    w)`` (NumPy-vectorized) on a uniform box grid."""
    xs = np.linspace(*x[:2], x[2])
    ys = np.linspace(*y[:2], y[2])
    zf = np.linspace(0.0, 1.0, z[2])
    zs = z[0] + zf * (z[1] - z[0])
    pz, py_, px = np.meshgrid(zs, ys, xs, indexing="ij")
    u, v, w = wind_fn(px, py_, pz)
    ny, nx = y[2], x[2]
    return WindField(
        min_x=float(xs[0]), min_y=float(ys[0]),
        res_x=float(xs[1] - xs[0]), res_y=float(ys[1] - ys[0]),
        vertical_spacing_factors=zf.astype(np.float32),
        bottom_z=np.full((ny, nx), z[0], np.float32),
        top_z=np.full((ny, nx), z[1], np.float32),
        u=np.broadcast_to(u, pz.shape).astype(np.float32),
        v=np.broadcast_to(v, pz.shape).astype(np.float32),
        w=np.broadcast_to(w, pz.shape).astype(np.float32),
    )


def wind_field_velocity(field: WindField, pos: Tensor) -> Tensor:
    """Trilinearly interpolated wind velocity at world positions ``pos``
    (..., 3): the z interpolation first, within each of the four
    surrounding columns at that column's own level heights, then bilinear
    in x and y.  Positions outside the grid clamp to the boundary value."""
    lead = pos.shape[:-1]
    pos = pos.reshape(-1, 3)  # (N,) indices: a 0-d index tensor would be read on the host
    nz, ny, nx = field.shape
    factors = device_const(field.vertical_spacing_factors, pos)
    bottom = device_const(field.bottom_z, pos)
    top = device_const(field.top_z, pos)
    uvw = device_const(np.stack([field.u, field.v, field.w], axis=-1), pos)  # (nz, ny, nx, 3)

    fx = (pos[..., 0] - field.min_x) / field.res_x
    fy = (pos[..., 1] - field.min_y) / field.res_y
    x_inf = torch.floor(fx).to(torch.int32).clamp(0, nx - 2).long()
    y_inf = torch.floor(fy).to(torch.int32).clamp(0, ny - 2).long()
    tx = (fx - x_inf.to(fx.dtype)).clamp(0.0, 1.0)[..., None]
    ty = (fy - y_inf.to(fy.dtype)).clamp(0.0, 1.0)[..., None]
    z = pos[..., 2:3]

    # The four surrounding columns (x0 y0, x1 y0, x0 y1, x1 y1) at once, each
    # z-interpolated at its own terrain-following level heights.
    ix = torch.stack([x_inf, x_inf + 1, x_inf, x_inf + 1], dim=-1)      # (N, 4)
    iy = torch.stack([y_inf, y_inf, y_inf + 1, y_inf + 1], dim=-1)
    bz, tz = bottom[iy, ix], top[iy, ix]
    zf = ((z - bz) / (tz - bz)).clamp(0.0, 1.0)
    j = (torch.searchsorted(factors, zf, right=True) - 1).clamp(0, nz - 2)
    z0 = bz + factors[j] * (tz - bz)
    z1 = bz + factors[j + 1] * (tz - bz)
    wz = ((z - z0) / (z1 - z0)).clamp(0.0, 1.0)[..., None]
    lo, hi = uvw[j, iy, ix], uvw[j + 1, iy, ix]                          # (N, 4, 3)
    c00, c10, c01, c11 = (lo + (hi - lo) * wz).unbind(-2)
    row0 = c00 + (c10 - c00) * tx
    row1 = c01 + (c11 - c01) * tx
    return (row0 + (row1 - row0) * ty).reshape(lead + (3,))


def wind_velocity_at(params: WindParams, field: Optional[WindField], state: WindState, t,
                     pos: Tensor, dt: float, noise: Optional[Tensor] = None,
                     seed: Optional[Tensor] = None,
                     step: Optional[Tensor] = None) -> Tuple[Tensor, WindState]:
    """The total wind at time ``t`` and position ``pos``: the temporal model
    (mean + gust + turbulence) plus the static field."""
    vel, new_state = wind_velocity(params, state, t, dt, noise, seed, step)
    if field is not None:
        vel = vel + wind_field_velocity(field, pos)
    return vel, new_state
