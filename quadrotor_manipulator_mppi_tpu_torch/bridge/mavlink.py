"""MAVLink v1 codec + HIL adapter — the ``gazebo_mavlink_interface`` analog.

The reference bridges Gazebo to a PX4-class autopilot over MAVLink
(``rotors_gazebo_plugins/src/gazebo_mavlink_interface.cpp``): it encodes the
simulated IMU/GPS/lidar/flow into ``HIL_SENSOR`` / ``HIL_STATE_QUATERNION`` /
``HIL_GPS`` / ``DISTANCE_SENSOR`` / ``HIL_OPTICAL_FLOW`` messages and decodes
``HIL_ACTUATOR_CONTROLS`` into rotor-speed references.  This module provides
the same capability for the in-framework plant: a dependency-free MAVLink
v1.0 wire codec (framing, X25 checksum with per-message CRC_EXTRA, the
standard size-sorted field layouts of the common dialect) plus the
reference's HIL conversions:

* the ISA troposphere pressure/temperature/density model of
  ``gazebo_mavlink_interface.cpp:462-505`` (lapse rate 0.0065 K/m, MSL
  288 K / 101325 Pa, exponents 5.256 / 4.256, 1 Pa pressure noise hook);
* NWU body -> NED/FRD component flips (the ``q_br`` rotation of
  ``:410-417``);
* the actuator decode pipeline ``(control + offset) * scaling +
  zero_position`` with armed/disarmed gating (``:676-717``).

Only the framing/codec lives here; transport is the caller's choice (the
reference uses UDP to PX4 — any byte stream works, including the QMM
bridge's TCP sockets).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAVLINK_STX = 0xFE  # v1.0 framing


def x25_crc(data: bytes, seed: int = 0xFFFF) -> int:
    """MAVLink's X.25 / CRC-16-CCITT accumulator."""
    acc = seed
    for b in data:
        tmp = (b ^ (acc & 0xFF)) & 0xFF
        tmp = (tmp ^ ((tmp << 4) & 0xFF)) & 0xFF
        acc = ((acc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF
    return acc


@dataclass(frozen=True)
class MessageSpec:
    """One message: wire-order fields (already size-sorted per the MAVLink
    serialization rule) + the dialect CRC_EXTRA byte."""

    msgid: int
    name: str
    crc_extra: int
    fields: Tuple[Tuple[str, str, int], ...]  # (name, struct fmt, count)

    @property
    def fmt(self) -> str:
        return "<" + "".join(f * n for _, f, n in self.fields)

    @property
    def length(self) -> int:
        return struct.calcsize(self.fmt)


def _spec(msgid, name, crc_extra, fields):
    return MessageSpec(
        msgid=msgid,
        name=name,
        crc_extra=crc_extra,
        fields=tuple((n, f, c) for n, f, c in fields),
    )


# Wire layouts of the common-dialect messages the reference HIL interface
# uses (fields size-sorted, declaration-stable — the MAVLink v1 rule).
MESSAGES: Dict[int, MessageSpec] = {
    s.msgid: s
    for s in [
        _spec(0, "HEARTBEAT", 50, [
            ("custom_mode", "I", 1), ("type", "B", 1), ("autopilot", "B", 1),
            ("base_mode", "B", 1), ("system_status", "B", 1),
            ("mavlink_version", "B", 1),
        ]),
        _spec(2, "SYSTEM_TIME", 137, [
            ("time_unix_usec", "Q", 1), ("time_boot_ms", "I", 1),
        ]),
        _spec(93, "HIL_ACTUATOR_CONTROLS", 47, [
            ("time_usec", "Q", 1), ("flags", "Q", 1),
            ("controls", "f", 16), ("mode", "B", 1),
        ]),
        _spec(107, "HIL_SENSOR", 108, [
            ("time_usec", "Q", 1),
            ("xacc", "f", 1), ("yacc", "f", 1), ("zacc", "f", 1),
            ("xgyro", "f", 1), ("ygyro", "f", 1), ("zgyro", "f", 1),
            ("xmag", "f", 1), ("ymag", "f", 1), ("zmag", "f", 1),
            ("abs_pressure", "f", 1), ("diff_pressure", "f", 1),
            ("pressure_alt", "f", 1), ("temperature", "f", 1),
            ("fields_updated", "I", 1),
        ]),
        _spec(113, "HIL_GPS", 124, [
            ("time_usec", "Q", 1), ("lat", "i", 1), ("lon", "i", 1),
            ("alt", "i", 1), ("eph", "H", 1), ("epv", "H", 1),
            ("vel", "H", 1), ("vn", "h", 1), ("ve", "h", 1), ("vd", "h", 1),
            ("cog", "H", 1), ("fix_type", "B", 1),
            ("satellites_visible", "B", 1),
        ]),
        _spec(114, "HIL_OPTICAL_FLOW", 237, [
            ("time_usec", "Q", 1), ("integration_time_us", "I", 1),
            ("integrated_x", "f", 1), ("integrated_y", "f", 1),
            ("integrated_xgyro", "f", 1), ("integrated_ygyro", "f", 1),
            ("integrated_zgyro", "f", 1),
            ("time_delta_distance_us", "I", 1), ("distance", "f", 1),
            ("temperature", "h", 1), ("sensor_id", "B", 1),
            ("quality", "B", 1),
        ]),
        _spec(115, "HIL_STATE_QUATERNION", 4, [
            ("time_usec", "Q", 1), ("attitude_quaternion", "f", 4),
            ("rollspeed", "f", 1), ("pitchspeed", "f", 1),
            ("yawspeed", "f", 1), ("lat", "i", 1), ("lon", "i", 1),
            ("alt", "i", 1), ("vx", "h", 1), ("vy", "h", 1), ("vz", "h", 1),
            ("ind_airspeed", "H", 1), ("true_airspeed", "H", 1),
            ("xacc", "h", 1), ("yacc", "h", 1), ("zacc", "h", 1),
        ]),
        _spec(132, "DISTANCE_SENSOR", 85, [
            ("time_boot_ms", "I", 1), ("min_distance", "H", 1),
            ("max_distance", "H", 1), ("current_distance", "H", 1),
            ("type", "B", 1), ("id", "B", 1), ("orientation", "B", 1),
            ("covariance", "B", 1),
        ]),
    ]
}
MESSAGES_BY_NAME: Dict[str, MessageSpec] = {
    s.name: s for s in MESSAGES.values()
}


def _flatten(spec: MessageSpec, values: Dict) -> list:
    out = []
    for name, _, count in spec.fields:
        v = values[name]
        if count == 1:
            out.append(v)
        else:
            seq = list(np.asarray(v).reshape(-1))
            if len(seq) != count:
                raise ValueError(
                    f"{spec.name}.{name} expects {count} elements, "
                    f"got {len(seq)}"
                )
            out.extend(seq)
    return out


def encode(
    name_or_id,
    values: Dict,
    seq: int = 0,
    sysid: int = 1,
    compid: int = 200,
) -> bytes:
    """Serialize one MAVLink v1 frame (sysid/compid default to the
    reference's ``encode_chan(1, 200, ...)``)."""
    spec = (
        MESSAGES_BY_NAME[name_or_id]
        if isinstance(name_or_id, str)
        else MESSAGES[name_or_id]
    )
    payload = struct.pack(spec.fmt, *_flatten(spec, values))
    header = struct.pack(
        "<BBBBBB", MAVLINK_STX, len(payload), seq & 0xFF, sysid, compid,
        spec.msgid,
    )
    crc = x25_crc(header[1:] + payload + bytes([spec.crc_extra]))
    return header + payload + struct.pack("<H", crc)


def _unpack(spec: MessageSpec, payload: bytes) -> Dict:
    raw = struct.unpack(spec.fmt, payload)
    out, i = {}, 0
    for name, _, count in spec.fields:
        out[name] = raw[i] if count == 1 else list(raw[i:i + count])
        i += count
    return out


@dataclass
class Parser:
    """Incremental v1 stream parser: feed bytes, collect decoded messages.

    Unknown message ids and CRC failures drop one byte and resync (the
    behavior of ``mavlink_parse_char`` in the reference's receive loop,
    ``gazebo_mavlink_interface.cpp:645-657``).
    """

    buf: bytearray = field(default_factory=bytearray)

    def push(self, data: bytes) -> List[Tuple[str, Dict]]:
        self.buf.extend(data)
        out = []
        while True:
            # resync to STX
            start = self.buf.find(bytes([MAVLINK_STX]))
            if start < 0:
                self.buf.clear()
                break
            if start > 0:
                del self.buf[:start]
            if len(self.buf) < 8:
                break
            length = self.buf[1]
            total = 6 + length + 2
            if len(self.buf) < total:
                break
            msgid = self.buf[5]
            frame = bytes(self.buf[:total])
            spec = MESSAGES.get(msgid)
            ok = False
            if spec is not None and spec.length == length:
                crc = x25_crc(frame[1:6 + length] + bytes([spec.crc_extra]))
                (rx_crc,) = struct.unpack("<H", frame[6 + length:total])
                if crc == rx_crc:
                    out.append((spec.name, _unpack(spec, frame[6:6 + length])))
                    ok = True
            if ok:
                del self.buf[:total]
            else:
                del self.buf[:1]  # bad frame: drop the STX, resync
        return out


# ---------------------------------------------------------------------------
# HIL conversions (gazebo_mavlink_interface.cpp ImuCallback / handle_message)
# ---------------------------------------------------------------------------

# ISA troposphere constants (:462-505)
_LAPSE_RATE = 0.0065
_TEMP_MSL = 288.0
_PRESSURE_MSL = 101325.0
_RHO_MSL = 1.225
KALT_ZURICH_M = 488.0  # reference home altitude (kAltZurich_m)


def isa_pressure(alt_msl: float) -> Tuple[float, float, float]:
    """(abs_pressure [Pa], temperature [K], density [kg/m^3]) at ``alt_msl``
    — the exact expressions of ``gazebo_mavlink_interface.cpp:462-505``."""
    t_local = _TEMP_MSL - _LAPSE_RATE * alt_msl
    pressure = _PRESSURE_MSL / (_TEMP_MSL / t_local) ** 5.256
    rho = _RHO_MSL / (_TEMP_MSL / t_local) ** 4.256
    return pressure, t_local, rho


def nwu_to_frd(v) -> np.ndarray:
    """Body-frame NWU -> FRD component flip (the q_br = (0,1,0,0) rotation
    of ``:410-417``): x unchanged, y and z negated."""
    v = np.asarray(v, np.float64)
    return v * np.array([1.0, -1.0, -1.0])


def hil_sensor_values(
    time_usec: int,
    accel_body_nwu,
    gyro_body_nwu,
    mag_body_nwu,
    alt_amsl: float,
    airspeed_body_x: float = 0.0,
    pressure_noise_pa: float = 0.0,
) -> Dict:
    """Build a HIL_SENSOR payload dict from NWU body-frame measurements,
    with the ISA pressure/temperature/density and differential-pressure
    terms of ``ImuCallback`` (:449-507)."""
    acc = nwu_to_frd(accel_body_nwu)
    gyro = nwu_to_frd(gyro_body_nwu)
    mag = nwu_to_frd(mag_body_nwu)
    pressure, t_local, rho = isa_pressure(alt_amsl)
    pressure += pressure_noise_pa
    g = 9.81
    return dict(
        time_usec=int(time_usec),
        xacc=float(acc[0]), yacc=float(acc[1]), zacc=float(acc[2]),
        xgyro=float(gyro[0]), ygyro=float(gyro[1]), zgyro=float(gyro[2]),
        xmag=float(mag[0]), ymag=float(mag[1]), zmag=float(mag[2]),
        abs_pressure=float(pressure * 0.01),  # hPa (:492)
        diff_pressure=float(0.005 * rho * airspeed_body_x ** 2),  # hPa (:503)
        pressure_alt=float(alt_amsl - pressure_noise_pa / (g * rho)),
        temperature=float(t_local - 273.0),
        fields_updated=4095,
    )


def hil_state_quaternion_values(
    time_usec: int,
    quat_wxyz_ned,
    omega_body_frd,
    lat_deg: float,
    lon_deg: float,
    alt_m: float,
    vel_ned,
    accel_body_frd,
    ind_airspeed: float = 0.0,
    true_airspeed: float = 0.0,
) -> Dict:
    """HIL_STATE_QUATERNION ground truth with the reference's integer
    scalings (:560-585): lat/lon in degE7, alt mm, vel cm/s, acc mG.

    Deviation: the reference forgets the cm/s scale on ``ind_airspeed``
    (``gazebo_mavlink_interface.cpp:577`` assigns ``vel_b.X()`` raw while
    scaling ``true_airspeed`` by 100 one line later); the MAVLink spec
    says uint16 cm/s for both, so we scale both."""
    vel = np.asarray(vel_ned, np.float64)
    acc = np.asarray(accel_body_frd, np.float64)
    om = np.asarray(omega_body_frd, np.float64)
    return dict(
        time_usec=int(time_usec),
        attitude_quaternion=[float(x) for x in quat_wxyz_ned],
        rollspeed=float(om[0]), pitchspeed=float(om[1]), yawspeed=float(om[2]),
        lat=int(lat_deg * 1e7), lon=int(lon_deg * 1e7),
        alt=int(alt_m * 1000),
        vx=int(vel[0] * 100), vy=int(vel[1] * 100), vz=int(vel[2] * 100),
        ind_airspeed=int(max(0.0, ind_airspeed * 100)),
        true_airspeed=int(max(0.0, true_airspeed * 100)),
        xacc=int(acc[0] * 1000), yacc=int(acc[1] * 1000),
        zacc=int(acc[2] * 1000),
    )


MOTOR_SPEED_FLAG = 1  # kMotorSpeedFlag (gazebo_mavlink_interface.h:228)
MAV_MODE_FLAG_SAFETY_ARMED = 128


@dataclass(frozen=True)
class ActuatorMap:
    """The (control + offset) * scaling + zero_position pipeline of
    ``handle_message`` (:676-717), per output channel."""

    n_out: int
    offset: Tuple[float, ...]
    scaling: Tuple[float, ...]
    zero_armed: Tuple[float, ...]
    zero_disarmed: Tuple[float, ...]

    @staticmethod
    def rotors(n: int, max_speed: float) -> "ActuatorMap":
        """PX4 convention: controls in [0, 1] scaled to rotor speed."""
        return ActuatorMap(
            n_out=n,
            offset=(0.0,) * n,
            scaling=(max_speed,) * n,
            zero_armed=(0.0,) * n,
            zero_disarmed=(0.0,) * n,
        )


def decode_actuator_controls(
    msg: Dict, amap: ActuatorMap
) -> Tuple[np.ndarray, bool]:
    """HIL_ACTUATOR_CONTROLS -> per-output references + armed flag."""
    armed = bool(int(msg["mode"]) & MAV_MODE_FLAG_SAFETY_ARMED)
    controls = np.asarray(msg["controls"], np.float64)
    out = np.empty(amap.n_out)
    for i in range(amap.n_out):
        if armed:
            out[i] = (controls[i] + amap.offset[i]) * amap.scaling[i] + \
                amap.zero_armed[i]
        else:
            out[i] = amap.zero_disarmed[i]
    return out, armed


# --- Earth magnetic-field declination (geo_mag_declination.cpp port) -------
# WMM-derived lookup: 10-degree grid over lat [-60, 60] x lon [-180, 180],
# int8 declination degrees (the MAV GEO table the reference's MAVLink plugin
# consults per fix, geo_mag_declination.cpp:59-74), with the same
# floor-to-grid / bound-clamp / bilinear semantics (:77-133).
_DECL_SAMPLING_RES = 10.0
_DECL_MIN_LAT, _DECL_MAX_LAT = -60.0, 60.0
_DECL_MIN_LON, _DECL_MAX_LON = -180.0, 180.0
_DECLINATION_TABLE = np.asarray([
    [46, 45, 44, 42, 41, 40, 38, 36, 33, 28, 23, 16, 10, 4, -1, -5, -9, -14, -19, -26, -33, -40, -48, -55, -61, -66, -71, -74, -75, -72, -61, -25, 22, 40, 45, 47, 46],
    [30, 30, 30, 30, 29, 29, 29, 29, 27, 24, 18, 11, 3, -3, -9, -12, -15, -17, -21, -26, -32, -39, -45, -51, -55, -57, -56, -53, -44, -31, -14, 0, 13, 21, 26, 29, 30],
    [21, 22, 22, 22, 22, 22, 22, 22, 21, 18, 13, 5, -3, -11, -17, -20, -21, -22, -23, -25, -29, -35, -40, -44, -45, -44, -40, -32, -22, -12, -3, 3, 9, 14, 18, 20, 21],
    [16, 17, 17, 17, 17, 17, 16, 16, 16, 13, 8, 0, -9, -16, -21, -24, -25, -25, -23, -20, -21, -24, -28, -31, -31, -29, -24, -17, -9, -3, 0, 4, 7, 10, 13, 15, 16],
    [12, 13, 13, 13, 13, 13, 12, 12, 11, 9, 3, -4, -12, -19, -23, -24, -24, -22, -17, -12, -9, -10, -13, -17, -18, -16, -13, -8, -3, 0, 1, 3, 6, 8, 10, 12, 12],
    [10, 10, 10, 10, 10, 10, 10, 9, 9, 6, 0, -6, -14, -20, -22, -22, -19, -15, -10, -6, -2, -2, -4, -7, -8, -8, -7, -4, 0, 1, 1, 2, 4, 6, 8, 10, 10],
    [9, 9, 9, 9, 9, 9, 8, 8, 7, 4, -1, -8, -15, -19, -20, -18, -14, -9, -5, -2, 0, 1, 0, -2, -3, -4, -3, -2, 0, 0, 0, 1, 3, 5, 7, 8, 9],
    [8, 8, 8, 9, 9, 9, 8, 8, 6, 2, -3, -9, -15, -18, -17, -14, -10, -6, -2, 0, 1, 2, 2, 0, -1, -1, -2, -1, 0, 0, 0, 0, 1, 3, 5, 7, 8],
    [8, 9, 9, 10, 10, 10, 10, 8, 5, 0, -5, -11, -15, -16, -15, -12, -8, -4, -1, 0, 2, 3, 2, 1, 0, 0, 0, 0, 0, -1, -2, -2, -1, 0, 3, 6, 8],
    [6, 9, 10, 11, 12, 12, 11, 9, 5, 0, -7, -12, -15, -15, -13, -10, -7, -3, 0, 1, 2, 3, 3, 3, 2, 1, 0, 0, -1, -3, -4, -5, -5, -2, 0, 3, 6],
    [5, 8, 11, 13, 15, 15, 14, 11, 5, -1, -9, -14, -17, -16, -14, -11, -7, -3, 0, 1, 3, 4, 5, 5, 5, 4, 3, 1, -1, -4, -7, -8, -8, -6, -2, 1, 5],
    [4, 8, 12, 15, 17, 18, 16, 12, 5, -3, -12, -18, -20, -19, -16, -13, -8, -4, -1, 1, 4, 6, 8, 9, 9, 9, 7, 3, -1, -6, -10, -12, -11, -9, -5, 0, 4],
    [3, 9, 14, 17, 20, 21, 19, 14, 4, -8, -19, -25, -26, -25, -21, -17, -12, -7, -2, 1, 5, 9, 13, 15, 16, 16, 13, 7, 0, -7, -12, -15, -14, -11, -6, -1, 3],
], np.float64)

# Zurich WMM2015 field in the magnetic-north (declination-free) frame,
# 1e5 x nT NED — the plugin zeroes the E component and reintroduces the
# local declination per fix (gazebo_mavlink_interface.cpp:210-217).
MAG_FIELD_D_NED = np.asarray([0.21523, 0.0, -0.42741])


def mag_declination(lat_deg: float, lon_deg: float) -> float:
    """Declination [rad] at a fix — ``get_mag_declination`` semantics
    (floor to the 10-degree grid, clamp at the table bounds, bilinear)."""
    lat, lon = float(lat_deg), float(lon_deg)
    if not (-90.0 <= lat <= 90.0) or not (-180.0 <= lon <= 180.0):
        return 0.0
    res = _DECL_SAMPLING_RES
    min_lat = int(lat / res) * res
    min_lon = int(lon / res) * res
    if lat <= _DECL_MIN_LAT:
        min_lat = _DECL_MIN_LAT
    if lat >= _DECL_MAX_LAT:
        min_lat = int(lat / res) * res - res
    if lon <= _DECL_MIN_LON:
        min_lon = _DECL_MIN_LON
    if lon >= _DECL_MAX_LON:
        min_lon = int(lon / res) * res - res
    i = int((-_DECL_MIN_LAT + min_lat) / res)
    j = int((-_DECL_MIN_LON + min_lon) / res)
    t = _DECLINATION_TABLE
    d_sw, d_se = t[i][j], t[i][j + 1]
    d_nw, d_ne = t[i + 1][j], t[i + 1][j + 1]
    fx = (lon - min_lon) / res
    fy = (lat - min_lat) / res
    d_min = fx * (d_se - d_sw) + d_sw
    d_max = fx * (d_ne - d_nw) + d_nw
    return float(np.deg2rad(fy * (d_max - d_min) + d_min))


def mag_field_ned(lat_deg: float, lon_deg: float) -> np.ndarray:
    """Local geomagnetic field (NED, 1e5 x nT): the magnetic-north-frame
    Zurich field rotated about D by the fix's declination (the plugin's
    ``q_dn`` rotation, gazebo_mavlink_interface.cpp:424-427)."""
    d = mag_declination(lat_deg, lon_deg)
    c, s = np.cos(d), np.sin(d)
    rz = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return rz @ MAG_FIELD_D_NED
