"""Camera-frame streaming over the QMM bridge — the gst-camera analog.

The reference's vendored ``gazebo_gst_camera_plugin.cpp`` pushes camera
frames into a GStreamer H.264/RTP/UDP pipeline at the camera rate
(``startGstThread``, udpsink to 127.0.0.1).  The QMM equivalent keeps the
one-socket bridge topology: a :class:`CameraPublisher` rate-limits frames
(the plugin's ``framerate`` cap) and pushes ``IMAGE`` frames to the solver
server, which retains the latest on the shared session; any dashboard or
tool polls it back with ``IMAGE_REQ`` (the same poll-the-shared-session
pattern as MONITOR/TELEMETRY).  Depth images stream raw float meters — no
codec, which is the right trade at the 64x48 analytic-camera sizes (12 KB
vs the plugin's 800 kbit/s H.264 budget).

:func:`ascii_depth` renders a depth frame as terminal half-block art — the
dashboard camera view (``qmm_dashboard --camera`` uses the C++ port of the
same mapping).

A copy of the JAX package's ``bridge/camera.py`` (host code over
``protocol.encode_image``/``decode_image``; it touches no device).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from . import protocol as proto


@dataclass
class CameraPublisher:
    """Rate-limited IMAGE push over an existing bridge socket."""

    sock: socket.socket
    rate_hz: float = 10.0
    seq: int = 0
    _last_t: float = field(default=float("-inf"), repr=False)

    def publish(self, image, t: float) -> bool:
        """Send ``image`` if the frame interval elapsed; returns whether a
        frame went out (the plugin's framerate-capped appsrc push)."""
        if t - self._last_t < 1.0 / self.rate_hz:
            return False
        self.sock.sendall(
            proto.encode(proto.encode_image(image, seq=self.seq, t=t))
        )
        self.seq += 1
        self._last_t = t
        return True


def fetch_image(
    sock: socket.socket, timeout: float = 2.0
) -> Tuple[Optional[np.ndarray], dict]:
    """Poll the server's latest camera frame (IMAGE_REQ -> IMAGE).

    Returns ``(None, {})`` if no IMAGE frame arrives within ``timeout``
    seconds (dead server, or only non-IMAGE traffic) — the overall deadline
    bounds the loop even when interleaved frames keep recv busy."""
    import time

    sock.sendall(proto.encode(proto.Frame(proto.MsgType.IMAGE_REQ, [])))
    deadline = time.monotonic() + timeout
    dec = proto.Decoder()
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None, {}
        sock.settimeout(remaining)
        try:
            data = sock.recv(1 << 16)
        except socket.timeout:
            return None, {}
        if not data:
            return None, {}
        dec.feed(data)
        for frame in dec.frames():
            if frame.type == proto.MsgType.IMAGE:
                return proto.decode_image(frame)


_RAMP = " .:-=+*#%@"


def ascii_depth(
    image: np.ndarray,
    width: int = 64,
    max_depth: Optional[float] = None,
) -> str:
    """Depth image -> ASCII art (near = dense glyph, far/invalid = blank).

    Downsamples by integer strides to about ``width`` columns with 2:1
    aspect correction for terminal cells.
    """
    img = np.asarray(image, np.float32)
    if img.ndim == 3:
        img = img[..., 0]
    sx = max(1, img.shape[1] // width)
    sy = max(1, 2 * sx)
    img = img[::sy, ::sx]
    finite = np.isfinite(img)
    if max_depth is None:
        max_depth = float(np.nanmax(np.where(finite, img, np.nan))) if finite.any() else 1.0
    # Near -> 1, far -> 0 (denser glyph = closer), invalid -> blank.
    norm = np.clip(1.0 - np.where(finite, img, max_depth) / max(max_depth, 1e-6),
                   0.0, 1.0)
    idx = np.where(finite, (norm * (len(_RAMP) - 1)).astype(int), 0)
    return "\n".join("".join(_RAMP[i] for i in row) for row in idx)
