"""The HIL session's parameters, apart from the session itself, so that
``convert`` can read them without importing the socket and MAVLink layer."""

from __future__ import annotations

from dataclasses import dataclass

KALT_ZURICH_M = 488.0  # reference home altitude (kAltZurich_m); mavlink.py's constant


@dataclass
class HilConfig:
    physics_dt: float = 0.001
    sensor_interval: int = 4       # HIL_SENSOR every N physics ticks (250 Hz)
    state_interval: int = 10       # HIL_STATE_QUATERNION every N ticks
    sysid: int = 1
    compid: int = 200              # the reference's encode_chan(1, 200, ...)
    lat_deg: float = 47.3667       # Zurich home (kLatZurich)
    lon_deg: float = 8.5500
    alt_home: float = KALT_ZURICH_M
