"""Occupancy-grid mapping: the ``gazebo_octomap_plugin`` analog.

Port of the JAX package's ``sim/occupancy.py``: a dense log-odds voxel grid
held as one tensor, updated by batched ray insertion (a fixed number of
equally spaced free-space samples per ray get the miss update, the endpoint
voxel the hit update), with octomap's defaults (p_hit 0.7, p_miss 0.4,
clamped to [0.12, 0.97]).  Queries are gathers; :func:`occupied_centers`
exports the top-N occupied voxels as sphere obstacles; :func:`distance_field`
is a chamfer-relaxation distance field (the voxblox ESDF analog).

Every function has static shapes and no data-dependent branch, so a
closed loop that maps on every control step can be captured in a CUDA
graph.  Two choices keep it deterministic and equal to the JAX package:

* the free samples and the endpoints go in two separate ``index_add_``
  calls, each adding one constant (or an exact zero) per sample, so the
  order in which the card's atomics land cannot change a sum;
* :func:`occupied_centers` selects with a stable descending sort, so among
  equal log-odds (sums of two constants, clamped: many voxels tie) the
  lower flat index comes first, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.device import device_const, resolve_device

Tensor = torch.Tensor

# octomap library defaults: P(hit)=0.7, P(miss)=0.4, clamping thresholds
# 0.12 / 0.97, occupancy threshold 0.5.
LOG_ODDS_HIT = math.log(0.7 / 0.3)
LOG_ODDS_MISS = math.log(0.4 / 0.6)
LOG_ODDS_MIN = math.log(0.12 / 0.88)
LOG_ODDS_MAX = math.log(0.97 / 0.03)
OCCUPIED_THRESHOLD = 0.0  # log-odds 0 == p 0.5


@dataclass(frozen=True)
class OccupancyParams:
    origin: Tuple[float, float, float] = (-5.0, -5.0, 0.0)
    resolution: float = 0.1           # [m] voxel edge
    shape: Tuple[int, int, int] = (100, 100, 40)
    n_free_samples: int = 32          # free-space samples per ray (static)
    max_range: float = 10.0           # rays longer than this only carve


class OccupancyGrid(NamedTuple):
    log_odds: Tensor                  # (nx, ny, nz)


def init_grid(params: OccupancyParams, dtype=torch.float32, device="cuda") -> OccupancyGrid:
    return OccupancyGrid(log_odds=torch.zeros(tuple(params.shape), dtype=dtype,
                                              device=resolve_device(device)))


def _voxel_index(params: OccupancyParams, pts: Tensor) -> Tuple[Tensor, Tensor]:
    """World points -> (indices (..., 3) int64, in bounds (...))."""
    origin = device_const(params.origin, pts)
    ijk = torch.floor((pts - origin) / params.resolution).to(torch.int64)
    axes = ijk.unbind(-1)
    inb = torch.stack([(i >= 0) & (i < n) for i, n in zip(axes, params.shape)], -1).all(-1)
    ijk = torch.stack([i.clamp(0, n - 1) for i, n in zip(axes, params.shape)], -1)
    return ijk, inb


def _ravel(params: OccupancyParams, ijk: Tensor) -> Tensor:
    _, ny, nz = params.shape
    return (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]


def insert_rays(params: OccupancyParams, grid: OccupancyGrid, origin_pos: Tensor,
                endpoints: Tensor, valid: Tensor) -> OccupancyGrid:
    """Batched log-odds ray insertion (octomap ``insertPointCloud``).

    ``origin_pos`` (3,) is the sensor origin, ``endpoints`` (R, 3) the ray
    ends and ``valid`` (R,) masks rays out.  Free-space carving uses
    ``n_free_samples`` equally spaced points strictly inside each ray
    (capped at ``max_range``); the endpoint gets the hit update unless the
    ray is longer than ``max_range``.  Cells hit in this scan are removed
    from its free set (a scatter-max hit mask)."""
    lo = grid.log_odds
    dtype = lo.dtype
    delta = endpoints - origin_pos[None, :]
    length = torch.linalg.norm(delta, dim=-1)
    over = length > params.max_range
    scale = torch.where(over, params.max_range / length.clamp(min=1e-9), 1.0)
    capped = origin_pos[None, :] + delta * scale[..., None]

    n = params.n_free_samples
    fr = (torch.arange(n, dtype=dtype, device=lo.device) + 0.5) / (n + 1)
    free_pts = origin_pos[None, None, :] + (capped - origin_pos[None, :])[:, None, :] \
        * fr[None, :, None]                                   # (R, S, 3)
    f_ijk, f_inb = _voxel_index(params, free_pts)
    f_w = (f_inb & valid[:, None]).to(dtype) * LOG_ODDS_MISS

    e_ijk, e_inb = _voxel_index(params, endpoints)
    e_hit = e_inb & valid & ~over
    e_w = e_hit.to(dtype) * LOG_ODDS_HIT

    e_flat = _ravel(params, e_ijk)
    hit_mask = torch.zeros(lo.numel(), dtype=torch.int32, device=lo.device).scatter_reduce_(
        0, e_flat, e_hit.to(torch.int32), reduce="amax")
    f_flat = _ravel(params, f_ijk)
    f_w = f_w * (1 - hit_mask[f_flat]).to(dtype)

    flat = lo.reshape(-1).clone()
    flat.index_add_(0, f_flat.reshape(-1), f_w.reshape(-1))
    flat.index_add_(0, e_flat, e_w)
    return OccupancyGrid(log_odds=torch.clamp(flat.reshape(lo.shape), LOG_ODDS_MIN,
                                              LOG_ODDS_MAX))


def occupancy_prob(grid: OccupancyGrid) -> Tensor:
    return torch.sigmoid(grid.log_odds)


def query(params: OccupancyParams, grid: OccupancyGrid, pts: Tensor) -> Tensor:
    """Occupancy probability at world points; out-of-bounds reads 0.5
    (unknown)."""
    ijk, inb = _voxel_index(params, pts)
    p = torch.sigmoid(grid.log_odds[ijk[..., 0], ijk[..., 1], ijk[..., 2]])
    return torch.where(inb, p, 0.5)


def voxel_centers(params: OccupancyParams) -> np.ndarray:
    """(nx*ny*nz, 3) world centers of every voxel (host-side helper)."""
    nx, ny, nz = params.shape
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ijk = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3)
    return np.asarray(params.origin) + (ijk + 0.5) * params.resolution


def occupied_centers(params: OccupancyParams, grid: OccupancyGrid, max_n: int = 64,
                     threshold: float = OCCUPIED_THRESHOLD) -> Tuple[Tensor, Tensor]:
    """The ``max_n`` most occupied voxels as solver obstacles: ``(centers
    (max_n, 3), radii (max_n,))``.  Slots whose log-odds are not above
    ``threshold`` get radius 0 (inert); live slots half the voxel diagonal.
    Ties keep the lower flat index first (a stable descending sort), as
    ``jax.lax.top_k`` does."""
    lo = grid.log_odds.reshape(-1)
    vals, idx = torch.sort(lo, descending=True, stable=True)
    vals, idx = vals[:max_n], idx[:max_n]
    _, ny, nz = params.shape
    ijk = torch.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz], dim=-1)
    centers = device_const(params.origin, lo) + (ijk.to(lo.dtype) + 0.5) * params.resolution
    r = 0.5 * params.resolution * math.sqrt(3.0)
    radii = torch.where(vals > threshold, r, 0.0).to(lo.dtype)
    return centers, radii


def save_npz(path: str, params: OccupancyParams, grid: OccupancyGrid) -> None:
    """Write the map and its geometry to ``path`` (.npz)."""
    np.savez(path, log_odds=grid.log_odds.detach().cpu().numpy(),
             origin=np.asarray(params.origin), resolution=params.resolution,
             n_free_samples=params.n_free_samples, max_range=params.max_range)


def load_npz(path: str, device="cuda") -> Tuple[OccupancyParams, OccupancyGrid]:
    with np.load(path) as d:
        lo = d["log_odds"]
        params = OccupancyParams(origin=tuple(float(x) for x in d["origin"]),
                                 resolution=float(d["resolution"]), shape=tuple(lo.shape),
                                 n_free_samples=int(d["n_free_samples"]),
                                 max_range=float(d["max_range"]))
        return params, OccupancyGrid(log_odds=torch.from_numpy(lo.copy()).to(
            resolve_device(device)))


# ---------------------------------------------------------------------------
# Distance field (the voxblox-ESDF analog)
# ---------------------------------------------------------------------------

def distance_field(params: OccupancyParams, grid: OccupancyGrid, max_dist: float = 2.0,
                   threshold: float = OCCUPIED_THRESHOLD) -> Tensor:
    """(nx, ny, nz) distance to the nearest occupied voxel [m], clamped at
    ``max_dist``: occupied voxels start at 0 and every other at
    ``max_dist``, then ceil(max_dist / resolution) sweeps of d <- min(d,
    shift(d) + resolution) over the six neighbours, the rows a shift wraps
    around reset to ``max_dist``.  The L1-chamfer upper bound of the
    Euclidean distance: conservative, the safe side for clearance costs."""
    res = params.resolution
    lo = grid.log_odds
    d = torch.where(lo > threshold, 0.0, max_dist).to(lo.dtype)
    for _ in range(int(np.ceil(max_dist / res))):
        for axis in range(3):
            for shift in (1, -1):
                rolled = torch.roll(d, shift, dims=axis)
                rolled.select(axis, 0 if shift == 1 else -1).fill_(max_dist)
                d = torch.minimum(d, rolled + res)
        d = torch.clamp(d, max=max_dist)
    return d


def query_distance(params: OccupancyParams, dist: Tensor, pts: Tensor,
                   max_dist: float = 2.0) -> Tensor:
    """Clearance [m] at world points from the distance field (nearest-voxel
    gather; out-of-bounds reads ``max_dist``)."""
    ijk, inb = _voxel_index(params, pts)
    d = dist[ijk[..., 0], ijk[..., 1], ijk[..., 2]]
    return torch.where(inb, d, max_dist)
