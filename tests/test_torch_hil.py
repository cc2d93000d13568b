"""The port's MAVLink codec and HIL session against the JAX package's, on
the CPU.

Every message spec encodes to the JAX module's bytes and round-trips
through the port's parser; the HIL conversions equal the JAX values
exactly (both float64 NumPy); the JAX package's ``tests/test_hil.py``
cases run on the port's session; and 100 ticks of a port session and a
JAX session on the same MAVLink commands agree (state within 1e-5, the
decoded message fields within float32 rounding of the state).  Every
socket is non-blocking or bounded.
"""

import os
import socket

import numpy as np
import pytest

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.bridge import hil as jhil
from quadrotor_manipulator_mppi_tpu.bridge import mavlink as jmav
from quadrotor_manipulator_mppi_tpu.models import multirotor as jmr
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.bridge import hil
from quadrotor_manipulator_mppi_tpu_torch.bridge import mavlink as mav
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr

from torch_parity import N, torch_one_thread  # noqa: F401

TOL_STATE = 1e-5
INT_RANGES = {"B": (0, 255), "H": (0, 65535), "h": (-32768, 32767), "I": (0, 2**32 - 1),
              "i": (-2**31, 2**31 - 1), "Q": (0, 2**64 - 1)}


def _values(spec, rng):
    """Random in-range values for every field of a message spec."""
    out = {}
    for name, fmt, count in spec.fields:
        if fmt == "f":
            v = [float(x) for x in rng.normal(0.0, 100.0, count).astype(np.float32)]
        else:
            lo, hi = INT_RANGES[fmt]
            v = [int(rng.integers(lo, hi, endpoint=True, dtype=np.uint64 if fmt == "Q"
                                  else np.int64)) for _ in range(count)]
        out[name] = v[0] if count == 1 else v
    return out


@pytest.mark.parametrize("name", sorted(jmav.MESSAGES_BY_NAME))
def test_encode_bytes_equal_jax_and_parse_back(name):
    rng = np.random.default_rng(len(name))
    spec = mav.MESSAGES_BY_NAME[name]
    jspec = jmav.MESSAGES_BY_NAME[name]
    assert (spec.msgid, spec.crc_extra, spec.fields) == (jspec.msgid, jspec.crc_extra,
                                                         jspec.fields)
    vals = _values(spec, rng)
    for seq, sysid, compid in ((0, 1, 200), (255, 42, 9)):
        frame = mav.encode(name, vals, seq=seq, sysid=sysid, compid=compid)
        assert frame == jmav.encode(name, vals, seq=seq, sysid=sysid, compid=compid)
        assert frame == mav.encode(spec.msgid, vals, seq=seq, sysid=sysid, compid=compid)
        [(got_name, got)] = mav.Parser().push(b"\x00\x13" + frame)
        assert got_name == name
        for field, fmt, count in spec.fields:
            want = vals[field]
            if fmt == "f":
                np.testing.assert_array_equal(np.float32(got[field]), np.float32(want))
            else:
                assert got[field] == want, field


def test_parser_streams_like_jax():
    rng = np.random.default_rng(5)
    frames = [jmav.encode(n, _values(jmav.MESSAGES_BY_NAME[n], rng), seq=i)
              for i, n in enumerate(sorted(jmav.MESSAGES_BY_NAME))]
    bad = frames[0][:-1] + bytes([frames[0][-1] ^ 0xFF])
    stream = b"\x13garbage" + bad + b"".join(frames) + b"\xfe\x05junk"
    for cut in (1, 5, 64):
        jp, tp = jmav.Parser(), mav.Parser()
        jout, tout = [], []
        for i in range(0, len(stream), cut):
            jout += jp.push(stream[i:i + cut])
            tout += tp.push(stream[i:i + cut])
        assert tout == jout and len(tout) == len(frames)
    assert mav.x25_crc(b"hello world") == jmav.x25_crc(b"hello world")


def test_hil_conversions_equal_jax():
    rng = np.random.default_rng(2)
    for _ in range(5):
        acc, gyro, mag = rng.normal(0, 3, 3), rng.normal(0, 0.5, 3), rng.normal(0, 0.3, 3)
        alt, air = float(rng.uniform(400, 600)), float(rng.uniform(0, 20))
        kw = dict(time_usec=int(rng.integers(0, 10**9)), accel_body_nwu=acc,
                  gyro_body_nwu=gyro, mag_body_nwu=mag, alt_amsl=alt, airspeed_body_x=air)
        assert mav.hil_sensor_values(**kw) == jmav.hil_sensor_values(**kw)
        quat = rng.normal(size=4)
        kw = dict(time_usec=7, quat_wxyz_ned=quat / np.linalg.norm(quat),
                  omega_body_frd=gyro, lat_deg=float(rng.uniform(-60, 60)),
                  lon_deg=float(rng.uniform(-170, 170)), alt_m=alt, vel_ned=rng.normal(0, 2, 3),
                  accel_body_frd=acc, ind_airspeed=air, true_airspeed=air)
        got, want = mav.hil_state_quaternion_values(**kw), jmav.hil_state_quaternion_values(**kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        lat, lon = float(rng.uniform(-80, 80)), float(rng.uniform(-180, 180))
        np.testing.assert_array_equal(mav.mag_field_ned(lat, lon), jmav.mag_field_ned(lat, lon))
        assert mav.mag_declination(lat, lon) == jmav.mag_declination(lat, lon)
        assert mav.isa_pressure(alt) == jmav.isa_pressure(alt)
        np.testing.assert_array_equal(mav.nwu_to_frd(acc), jmav.nwu_to_frd(acc))
    for mode in (0, mav.MAV_MODE_FLAG_SAFETY_ARMED):
        msg = dict(time_usec=1, flags=mav.MOTOR_SPEED_FLAG, mode=mode,
                   controls=list(rng.uniform(0, 1, 16)))
        got = mav.decode_actuator_controls(msg, mav.ActuatorMap.rotors(8, 650.0))
        want = jmav.decode_actuator_controls(msg, jmav.ActuatorMap.rotors(8, 650.0))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == bool(mode)


def test_hil_config_crosses_from_jax():
    cfg = jhil.HilConfig(sensor_interval=3, lat_deg=40.0)
    got = convert.config_from_dict(jcfg.to_dict(cfg))
    assert isinstance(got, hil.HilConfig) and got == hil.HilConfig(sensor_interval=3,
                                                                   lat_deg=40.0)


def test_hil_config_defaults_match_jax_without_the_mavlink_layer():
    """The port's HilConfig (``bridge/config``) has the JAX defaults, its
    home altitude is mavlink's constant, and importing ``convert`` (which
    reads it) imports neither the HIL session nor the MAVLink layer."""
    import dataclasses
    import subprocess
    import sys

    from quadrotor_manipulator_mppi_tpu_torch.bridge import config as bcfg

    assert dataclasses.asdict(bcfg.HilConfig()) == dataclasses.asdict(jhil.HilConfig())
    assert bcfg.KALT_ZURICH_M == mav.KALT_ZURICH_M and hil.HilConfig is bcfg.HilConfig
    code = ("import sys, quadrotor_manipulator_mppi_tpu_torch.convert; "
            "print(sorted(m for m in sys.modules if m.endswith(('bridge.hil', 'bridge.mavlink', "
            "'bridge.server'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=30, cwd=os.path.dirname(os.path.dirname(__file__)) or ".")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _autopilot():
    ap = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ap.bind(("127.0.0.1", 0))
    ap.setblocking(False)
    return ap


def _controls_frame(cmd, n_rotors, armed=True):
    controls = [cmd] * n_rotors + [0.0] * (16 - n_rotors)
    return mav.encode("HIL_ACTUATOR_CONTROLS", dict(
        time_usec=0, flags=mav.MOTOR_SPEED_FLAG, controls=controls,
        mode=mav.MAV_MODE_FLAG_SAFETY_ARMED if armed else 0))


def _drain(ap, parser, sink):
    try:
        while True:
            data, _ = ap.recvfrom(4096)
            sink.extend(parser.push(data))
    except BlockingIOError:
        pass


def test_hil_udp_loop_climbs_under_mavlink_control():
    """tests/test_hil.py's climb: an above-hover armed command over MAVLink,
    600 ticks, both HIL streams consistent with the climb."""
    veh = mr.MultirotorParams()
    ap = _autopilot()
    session = hil.HilSession(vehicle=veh, bind=("127.0.0.1", 0), peer=ap.getsockname(),
                             device="cpu")
    try:
        hover = veh.hover_rotor_speed(extra_mass=0.0)
        ap.sendto(_controls_frame(min(1.0, 1.05 * hover / veh.max_rotor_speed), veh.n_rotors),
                  session.address)
        parser, got = mav.Parser(), []
        for _ in range(600):
            session.tick()
            _drain(ap, parser, got)
        got = dict(got)
        assert session.armed
        assert float(session.plant.pos[2]) > 0.05
        assert "HIL_SENSOR" in got and "HIL_STATE_QUATERNION" in got
        state = got["HIL_STATE_QUATERNION"]
        assert state["alt"] > int(mav.KALT_ZURICH_M * 1000)
        assert state["vz"] < 0
        sensor = got["HIL_SENSOR"]
        assert sensor["zacc"] < -5.0
        assert 900.0 < sensor["abs_pressure"] < 1013.0
    finally:
        session.close()
        ap.close()


def test_hil_disarmed_stays_grounded():
    veh = mr.MultirotorParams()
    ap = _autopilot()
    session = hil.HilSession(vehicle=veh, bind=("127.0.0.1", 0), peer=ap.getsockname(),
                             device="cpu")
    try:
        ap.sendto(_controls_frame(1.0, 16, armed=False), session.address)
        for _ in range(200):
            session.tick()
        assert not session.armed
        np.testing.assert_allclose(session.rotor_cmd, 0.0)
        assert abs(float(session.plant.pos[2])) < 1e-3
    finally:
        session.close()
        ap.close()


def test_hil_ticks_match_jax_session():
    """100 ticks of a port session and a JAX session, each driven by its own
    loopback autopilot with the same commands (a climb, then a differential
    command from tick 50): the state within 1e-5 at every tick, and every
    decoded HIL_SENSOR / HIL_STATE_QUATERNION field within float32 rounding
    (floats 1e-6 relative and absolute; the integer fields within one
    unit, a rounding boundary)."""
    veh, jveh = mr.MultirotorParams(), jmr.MultirotorParams()
    aps = [_autopilot(), _autopilot()]
    ts = hil.HilSession(vehicle=veh, peer=aps[0].getsockname(), device="cpu")
    js = jhil.HilSession(vehicle=jveh, peer=aps[1].getsockname())
    parsers, msgs = [mav.Parser(), jmav.Parser()], [[], []]
    hover = veh.hover_rotor_speed() / veh.max_rotor_speed
    try:
        for i in range(100):
            if i in (0, 50):
                controls = [1.1 * hover] * 8 if i == 0 else list(
                    hover * (1.0 + 0.05 * np.sin(np.arange(8.0))))
                for ap, s in zip(aps, (ts, js)):
                    ap.sendto(mav.encode("HIL_ACTUATOR_CONTROLS", dict(
                        time_usec=i, flags=mav.MOTOR_SPEED_FLAG,
                        controls=controls + [0.0] * 8, mode=mav.MAV_MODE_FLAG_SAFETY_ARMED)),
                        s.address)
            ts.tick()
            js.tick()
            for k in range(2):
                _drain(aps[k], parsers[k], msgs[k])
            for f in mr.MultirotorState._fields:
                np.testing.assert_allclose(N(getattr(ts.plant, f)),
                                           np.asarray(getattr(js.plant, f)), rtol=TOL_STATE,
                                           atol=TOL_STATE, err_msg=f"tick {i}: {f}")
        np.testing.assert_array_equal(ts.rotor_cmd, js.rotor_cmd)
        assert ts.armed and js.armed and float(ts.plant.pos[2]) > 0.0
        assert [n for n, _ in msgs[0]] == [n for n, _ in msgs[1]]
        assert len(msgs[0]) == 100 // 4 + 100 // 10
        for (name, got), (_, want) in zip(*msgs):
            for field, fmt, _ in mav.MESSAGES_BY_NAME[name].fields:
                g, w = np.asarray(got[field], np.float64), np.asarray(want[field], np.float64)
                if fmt == "f":
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                               err_msg=f"{name}.{field}")
                else:
                    np.testing.assert_allclose(g, w, rtol=0, atol=1, err_msg=f"{name}.{field}")
    finally:
        ts.close()
        js.close()
        for ap in aps:
            ap.close()


def test_hil_session_without_peer_learns_it_from_the_first_datagram():
    ap = _autopilot()
    s = hil.HilSession(device="cpu")
    try:
        ap.sendto(_controls_frame(0.5, 8), s.address)
        for _ in range(20):
            s.tick()
        assert s.peer == ap.getsockname() and s.armed
        np.testing.assert_allclose(s.rotor_cmd[:8], 0.5 * mr.MultirotorParams().max_rotor_speed)
        got = []
        _drain(ap, mav.Parser(), got)
        assert [n for n, _ in got].count("HIL_SENSOR") == 20 // 4
    finally:
        s.close()
        ap.close()
