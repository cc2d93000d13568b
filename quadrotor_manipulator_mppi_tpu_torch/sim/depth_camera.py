"""Depth camera: a pinhole render of the analytic scene and the RotorS
noisy-depth sensor models.

Port of the JAX package's ``sim/depth_camera.py`` (the reference's
``gazebo_noisydepth_plugin`` and its ``depth_noise_model.cpp``).  The
render is a vectorized pinhole ray cast against the primitives the lidar
and the solver's obstacle costs use (a ground plane and spheres); here it
takes any leading frame axes, (F, 3) positions and (F, 3, 3) rotations
giving (F, H, W) images, so one call renders every frame of a flight.  The
three noise models (Kinect, PMD, RealSense D435) keep the reference's
quirks, as the JAX package does:

* the Kinect and PMD models scale a unit normal by the *variance*
  expression (the reference names it ``var_noise`` and uses it as a
  standard deviation), and
* the D435 model squares the whitepaper RMS once more before use.

Pixels that hit nothing render as +inf (or ``background``); the noise
models turn out-of-range pixels into NaN bad points, as upstream.  Each
noise model takes its standard normals explicitly (``noise``, the shape of
the depth image) or draws them from the Philox stream of ``ops/sampling``
under a ``(seed, step)`` pair (``sim/sensors.normals``, one normal per
pixel in row-major order), so a test can feed the JAX draws to both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import sensors

Tensor = torch.Tensor


@dataclass(frozen=True)
class DepthCameraParams:
    """Pinhole geometry.  Optical frame: +z along the optical axis, +x
    right, +y down (the ROS ``camera_optical_frame``); the ``rot`` given to
    :func:`depth_render` maps optical -> world."""

    width: int = 64
    height: int = 48
    h_fov: float = float(np.pi / 2)   # horizontal FOV [rad] (D435 default)
    min_depth: float = 0.2            # [m] DepthNoiseModel defaults
    max_depth: float = 1000.0

    @property
    def focal(self) -> float:
        return 0.5 * self.width / float(np.tan(0.5 * self.h_fov))


def _pixel_grid(params: DepthCameraParams, like: Tensor) -> Tuple[Tensor, Tensor]:
    """(H, W) pixel offsets from the image centre, u across and v down."""
    u = torch.arange(params.width, dtype=like.dtype, device=like.device) - 0.5 * (params.width - 1)
    v = torch.arange(params.height, dtype=like.dtype, device=like.device) \
        - 0.5 * (params.height - 1)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return uu, vv


def depth_render(
    params: DepthCameraParams,
    pos: Tensor,                              # (..., 3) camera position, world
    rot: Tensor,                              # (..., 3, 3) optical -> world
    ground_z: float = 0.0,
    sphere_centers: Optional[Tensor] = None,  # (N, 3)
    sphere_radii: Optional[Tensor] = None,    # (N,)
    background: Optional[float] = None,
) -> Tensor:
    """(..., H, W) z-depth images of the analytic scene: the distance along
    the optical axis, like Gazebo's depth camera, not the ray length.
    Pixels that hit nothing get ``background`` (default +inf, which the
    noise models turn into NaN bad points)."""
    f = params.focal
    uu, vv = _pixel_grid(params, pos)
    dirs_c = torch.stack([uu / f, vv / f, torch.ones_like(uu)], dim=-1)
    dirs_c = dirs_c / torch.linalg.norm(dirs_c, dim=-1, keepdim=True)
    dirs_w = torch.einsum("...ij,hwj->...hwi", rot, dirs_c)       # (..., H, W, 3)
    cos_axis = dirs_c[..., 2]                                     # ray-to-axis cosine
    p = pos[..., None, None, :]                                   # (..., 1, 1, 3)

    dz = dirs_w[..., 2]
    t_ground = (ground_z - p[..., 2]) / torch.where(dz.abs() < 1e-9, -1e-9, dz)
    t_best = torch.where(t_ground > 0.0, t_ground, torch.inf)

    if sphere_centers is not None and sphere_radii is not None:
        oc = p[..., None, :] - sphere_centers                     # (..., 1, 1, N, 3)
        d = dirs_w[..., None, :]                                  # (..., H, W, 1, 3)
        b = torch.sum(d * oc, dim=-1)                             # (..., H, W, N)
        c = torch.sum(oc * oc, dim=-1) - sphere_radii ** 2
        disc = b * b - c
        t_hit = -b - torch.sqrt(disc.clamp(min=0.0))
        valid = (disc > 0.0) & (t_hit > 0.0)
        t_sph = torch.where(valid, t_hit, torch.inf)
        t_best = torch.minimum(t_best, torch.amin(t_sph, dim=-1))

    depth = t_best * cos_axis
    big = torch.inf if background is None else float(background)
    return torch.where(torch.isfinite(depth), depth, big)


def _in_range(params: DepthCameraParams, depth: Tensor) -> Tensor:
    return (depth > params.min_depth) & (depth < params.max_depth)


def _normals(depth: Tensor, noise: Optional[Tensor], seed: Optional[Tensor],
             step) -> Tensor:
    """``noise`` as it is (the shape of ``depth``), or one Philox normal
    per pixel under ``(seed, step)``."""
    if noise is None:
        if seed is None:
            raise ValueError("pass standard normals (noise=) or a (seed, step) pair")
        noise = sensors.normals(depth.numel(), seed, step).reshape(depth.shape)
    if noise.shape != depth.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for a depth image of shape "
                         f"{tuple(depth.shape)}")
    return noise.to(depth.dtype)


def _apply(params: DepthCameraParams, depth: Tensor, scale: Tensor, noise, seed, step) -> Tensor:
    noisy = depth + scale * _normals(depth, noise, seed, step)
    return torch.where(_in_range(params, depth), noisy, torch.nan)


def kinect_depth_noise(params: DepthCameraParams, depth: Tensor, noise: Optional[Tensor] = None,
                       seed: Optional[Tensor] = None, step=None) -> Tensor:
    """Kinect axial noise, the Nguyen et al. model sigma_z(z) = 0.0012 +
    0.0019 (z - 0.4)^2, multiplying the unit normal directly (the
    reference's quirk)."""
    return _apply(params, depth, 0.0012 + 0.0019 * (depth - 0.4) ** 2, noise, seed, step)


def pmd_depth_noise(params: DepthCameraParams, depth: Tensor, noise: Optional[Tensor] = None,
                    seed: Optional[Tensor] = None, step=None) -> Tensor:
    """PMD time-of-flight: 1 % of depth."""
    return _apply(params, depth, 0.01 * depth, noise, seed, step)


def d435_depth_noise(params: DepthCameraParams, depth: Tensor, noise: Optional[Tensor] = None,
                     seed: Optional[Tensor] = None, step=None, baseline: float = 0.05,
                     subpixel_err: float = 0.1, max_stdev: float = 3.0) -> Tensor:
    """RealSense D435 subpixel-disparity model: RMS = (z[mm])^2 subpixel /
    (f baseline 1e6), squared once more (the reference's quirk) and
    clipped at ``max_stdev``."""
    multiplier = subpixel_err / (params.focal * baseline * 1e6)
    rms = (depth * 1000.0) ** 2 * multiplier
    return _apply(params, depth, torch.clamp(rms * rms, max=max_stdev), noise, seed, step)


NOISE_MODELS = {
    "kinect": kinect_depth_noise,
    "pmd": pmd_depth_noise,
    "d435": d435_depth_noise,
}


def noisy_depth(params: DepthCameraParams, depth: Tensor, model: str = "kinect",
                noise: Optional[Tensor] = None, seed: Optional[Tensor] = None, step=None,
                **kwargs) -> Tensor:
    """Apply the named noise model (the plugin's model selection, Kinect by
    default; the name is case-blind)."""
    return NOISE_MODELS[model.lower()](params, depth, noise=noise, seed=seed, step=step,
                                       **kwargs)


def depth_to_points(params: DepthCameraParams, depth: Tensor, pos: Tensor,
                    rot: Tensor) -> Tuple[Tensor, Tensor]:
    """Back-project (..., H, W) depth images (NaN = bad) to world points.

    Returns ``(points (..., H*W, 3), valid (..., H*W))``: invalid (NaN or
    clipped) pixels get their camera-frame point zeroed and
    ``valid=False``, so the shapes stay fixed and consumers weight by
    ``valid``."""
    f = params.focal
    uu, vv = _pixel_grid(params, depth)
    valid = torch.isfinite(depth) & (depth > params.min_depth)
    z = torch.where(valid, depth, torch.zeros_like(depth))
    pts_c = torch.stack([uu / f * z, vv / f * z, z], dim=-1)
    pts_w = pos[..., None, None, :] + torch.einsum("...ij,...hwj->...hwi", rot, pts_c)
    lead = depth.shape[:-2]
    return pts_w.reshape(lead + (-1, 3)), valid.reshape(lead + (-1,))
