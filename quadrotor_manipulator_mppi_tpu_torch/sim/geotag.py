"""Geotagged image capture: periodic camera frames stamped with GPS fixes.

Port of the JAX package's ``sim/geotag.py`` (the reference's geotagged
images plugin: keep the latest GPS fix and, every ``interval`` seconds,
store the camera frame to a numbered file tagged with the fix).  The GPS
fix is the flat-earth sensor model (``sim/sensors.gps_measure``) converted
to geodetic coordinates about a home origin on a spherical earth (the
reference's ``kEarthRadiusMeters = 6356766.0``; the Zurich home of the
MAVLink stack), and each artifact is an ``.npz`` carrying the image, the
tag and the camera pose, the JAX package's fields.

:class:`GeotagRecorder` and :func:`local_to_geodetic` are host code, a copy
of the JAX package's.  :func:`replay_capture` replays a logged flight
through the capture stack on the logs' device: the schedule (which ticks
get a GPS fix, which a frame) depends only on the tick count, the stride
and the interval, so it is worked out on the host first; then every GPS
fix is drawn in one call and every captured frame rendered and noised in
one call, the frames, fixes and camera rotations come back to the host in
one copy, and the recorder and the publisher are fed in the JAX order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

EARTH_RADIUS_M = 6356766.0   # the reference's kEarthRadiusMeters


@dataclass(frozen=True)
class GeotagParams:
    """Capture cadence (the reference's SDF ``interval``, 1 s by default)
    and the home geodetic origin (the MAVLink stack's Zurich constants)."""

    interval: float = 1.0
    lat_home_deg: float = 47.3667
    lon_home_deg: float = 8.5500
    alt_home_m: float = 488.0
    prefix: str = "DSC"          # file stem (the plugin's frames/DSC%05i.jpg)


def local_to_geodetic(params: GeotagParams, pos_xyz) -> Dict[str, float]:
    """Flat-earth local NWU (x north, y west, z up) offset -> lat/lon/alt
    about the home origin on a spherical earth."""
    x, y, z = (float(v) for v in np.asarray(pos_xyz, np.float64))
    lat0 = np.deg2rad(params.lat_home_deg)
    lat = params.lat_home_deg + np.rad2deg(x / EARTH_RADIUS_M)
    # NWU: +y is west, so the longitude decreases.
    lon = params.lon_home_deg - np.rad2deg(y / (EARTH_RADIUS_M * np.cos(lat0)))
    return {"lat_deg": float(lat), "lon_deg": float(lon), "alt_m": float(params.alt_home_m + z)}


@dataclass
class GeotagRecorder:
    """Stateful capture loop: feed it frames and the latest GPS fix; it
    stores one artifact per interval (the plugin's ``OnNewFrame`` and
    ``OnNewGpsPosition`` pair)."""

    params: GeotagParams = field(default_factory=GeotagParams)
    out_dir: str = "frames"
    counter: int = 0
    last_capture_t: float = float("-inf")
    last_gps_xyz: Optional[np.ndarray] = None
    written: List[str] = field(default_factory=list)

    def on_gps(self, pos_xyz) -> None:
        """The latest GPS fix in local coordinates."""
        self.last_gps_xyz = np.asarray(pos_xyz, np.float64)

    def on_frame(self, t: float, image, cam_pos=None, cam_rot=None) -> Optional[str]:
        """Store the frame if the interval elapsed; returns the written
        path or None.  Frames before any GPS fix are dropped (an untagged
        artifact is useless downstream)."""
        if t - self.last_capture_t < self.params.interval:
            return None
        if self.last_gps_xyz is None:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        tag = local_to_geodetic(self.params, self.last_gps_xyz)
        path = os.path.join(self.out_dir, f"{self.params.prefix}{self.counter:05d}.npz")
        np.savez_compressed(
            path,
            image=np.asarray(image),
            t=np.float64(t),
            gps_local_xyz=np.asarray(self.last_gps_xyz, np.float64),
            lat_deg=np.float64(tag["lat_deg"]),
            lon_deg=np.float64(tag["lon_deg"]),
            alt_m=np.float64(tag["alt_m"]),
            cam_pos=np.zeros(3) if cam_pos is None else np.asarray(cam_pos, np.float64),
            cam_rot=np.eye(3) if cam_rot is None else np.asarray(cam_rot, np.float64),
        )
        self.counter += 1
        self.last_capture_t = t
        self.written.append(path)
        return path


def capture_schedule(rec: GeotagRecorder, n_ticks: int, stride: int = 100,
                     dt: float = 1e-3) -> tuple:
    """The ticks of a replay, worked out on the host: every ``stride``-th
    tick gets a GPS fix, and those at which ``rec``'s interval has elapsed
    (counting from its last capture) a frame.  Returns ``(fix_ticks,
    frame_ticks)``; the arithmetic is the JAX replay's, float for float."""
    fix_ticks = list(range(0, n_ticks, stride))
    frames, last = [], rec.last_capture_t
    for i in fix_ticks:
        t = i * dt
        if t - last >= rec.params.interval:
            frames.append(i)
            last = t
    return fix_ticks, frames


def replay_capture(rec: GeotagRecorder, pos_log: torch.Tensor, quat_log: torch.Tensor,
                   gimbal_log: torch.Tensor, cam, seed: torch.Tensor, sphere_centers,
                   sphere_radii, gps_params=None, noise_model: str = "kinect",
                   stride: int = 100, dt: float = 1e-3, publisher=None) -> dict:
    """Replay a logged flight (per-tick position (T, 3), attitude (T, 4)
    and gimbal angles (T, 3), tensors on any device) through the capture
    stack: every ``stride`` ticks a GPS fix, and every capture interval the
    gimbal-steered depth frame (``sim/depth_camera``) with the sensor's
    noise, geotagged and stored.  ``publisher`` (a
    ``bridge.camera.CameraPublisher``) also streams each captured frame.

    The noise draws from the Philox stream under the key ``seed`` (a (1,)
    int64 tensor on the logs' device): the GPS fixes' (horizontal x, y,
    vertical) normals under counter 0, fix after fix, and the frames' one
    normal per pixel under counter 1, frame after frame.  Returns the
    device results: ``frames`` (F, H, W), ``fixes`` (n_fixes, 3) and
    ``rot`` (F, 3, 3)."""
    from . import depth_camera as dc
    from . import gimbal as gb
    from .sensors import GpsParams, gps_measure

    gps = gps_params or GpsParams(horizontal_noise=0.05, vertical_noise=0.1)
    dev, dtype = pos_log.device, pos_log.dtype
    fix_ticks, frame_ticks = capture_schedule(rec, pos_log.shape[0], stride, dt)
    idx_fix = torch.tensor(fix_ticks, dtype=torch.int64).to(dev)
    idx_frame = torch.tensor(frame_ticks, dtype=torch.int64).to(dev)

    fixes = gps_measure(gps, pos_log[idx_fix], seed=seed, step=0)
    pos_f = pos_log[idx_frame]
    gim = gb.GimbalState(angles=gimbal_log[idx_frame], rates=torch.zeros_like(pos_f))
    rot_cw = gb.camera_rotation(gim, quat_log[idx_frame])
    depth = dc.depth_render(cam, pos_f, rot_cw,
                            sphere_centers=torch.as_tensor(sphere_centers, dtype=dtype).to(dev),
                            sphere_radii=torch.as_tensor(sphere_radii, dtype=dtype).to(dev))
    frames = dc.noisy_depth(cam, depth, model=noise_model, seed=seed, step=1)

    # One copy back to the host for the whole replay.
    host = torch.cat([frames.reshape(-1), fixes.reshape(-1), rot_cw.reshape(-1),
                      pos_f.reshape(-1)]).cpu().numpy()
    n_fr, n_fx = frames.numel(), fixes.numel()
    frames_np = host[:n_fr].reshape(frames.shape)
    fixes_np = host[n_fr:n_fr + n_fx].reshape(fixes.shape)
    rest = host[n_fr + n_fx:]
    rot_np = rest[:rot_cw.numel()].reshape(rot_cw.shape)
    pos_np = rest[rot_cw.numel():].reshape(pos_f.shape)

    j = 0
    for n, i in enumerate(fix_ticks):
        rec.on_gps(fixes_np[n])
        if j < len(frame_ticks) and frame_ticks[j] == i:
            t = i * dt
            rec.on_frame(t, frames_np[j], cam_pos=pos_np[j], cam_rot=rot_np[j])
            if publisher is not None:
                publisher.publish(frames_np[j], t)
            j += 1
    return {"frames": frames, "fixes": fixes, "rot": rot_cw}
