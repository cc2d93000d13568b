"""The port's solver bridge against the JAX package's, on the CPU.

The wire (``bridge/protocol``) byte for byte; ``SolverSession`` and
``WholeBodySession`` on the JAX sessions' own key chains (their normals
fed to the port: the arm solve within 2e-3 of the largest |tau|, the
drone setpoint within 2e-4, the whole-body head within 2e-3); the action
interface; the JAX package's ``tests/test_bridge.py`` and
``tests/test_ros_adapter_parity.py`` cases on the port's server; the sim
adapter against the server, and its control period against ten calls of
the JAX adapter's tick (2e-4 per field, 5e-3 over 20 periods; ROADMAP
note a); the native round-trip client against the port's server.  Every
socket wait and subprocess has a timeout of 30 s or less.
"""

import os
import shutil
import socket
import struct
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.bridge import protocol as jproto
from quadrotor_manipulator_mppi_tpu.bridge import server as jserver
from quadrotor_manipulator_mppi_tpu.bridge import sim_adapter as jsim
from quadrotor_manipulator_mppi_tpu.sim import flight_control as jfc
from quadrotor_manipulator_mppi_tpu.solver import arm as jarm
from quadrotor_manipulator_mppi_tpu.solver import drone as jdrone
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu.solver.mppi import MPPIConfig as JMPPIConfig
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.bridge import action
from quadrotor_manipulator_mppi_tpu_torch.bridge import protocol as proto
from quadrotor_manipulator_mppi_tpu_torch.bridge import sim_adapter
from quadrotor_manipulator_mppi_tpu_torch.bridge.ros_adapter import RosQmmAdapter
from quadrotor_manipulator_mppi_tpu_torch.bridge.server import (
    BridgeServer, SolverSession, WholeBodySession,
)
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

from torch_parity import N, T, torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
TIMEOUT = 30.0
TOL_SOLVE = 2e-3    # tests/test_torch_arm.py: of the largest |tau|
TOL_DRONE = 2e-4    # tests/test_torch_drone.py
TOL_HEAD = 2e-3     # tests/test_torch_serving.py's bridge head
TOL_PERIOD = 2e-4   # one control period of the plant (ROADMAP note a)
TOL_PERIODS = 5e-3  # 20 periods
K, H = 32, 8        # tests/test_bridge.py's small session
WB_K, WB_H = 64, 8
HOME = [1.57, 1.7, 0.0, 4.4, 0.0, 4.71, 0.0]


def jax_small_params():
    return (jarm.ArmMPPIParams(mppi=JMPPIConfig(n_samples=K, n_horizon=H, n_action=7, dt=0.01,
                                                lam=0.1, sigma=0.1, savgol_window=5)),
            jdrone.DroneMPPIParams(mppi=JMPPIConfig(n_samples=K, n_horizon=H, n_action=3,
                                                    dt=0.01, lam=0.1, sigma=30.0,
                                                    savgol_window=5)))


def small_session(seed=0):
    """tests/test_bridge.py's small session on the port (CPU), built from
    the JAX parameter trees."""
    ap, dp = jax_small_params()
    return SolverSession(arm_params=convert.config_from_dict(jcfg.to_dict(ap)),
                         drone_params=convert.config_from_dict(jcfg.to_dict(dp)),
                         seed=seed, device="cpu")


def hover_state(q=None):
    state = [0.0] * 27
    state[2] = 2.1
    state[6] = 1.0
    if q is not None:
        state[7:14] = list(q)
    return state


def recv_frames(sock, dec, want, timeout=TIMEOUT):
    """Frames from ``sock`` until ``want`` (a count) arrived; each wait
    bounded by ``timeout``."""
    sock.settimeout(timeout)
    got = list(dec.frames())
    deadline = time.time() + timeout
    while len(got) < want:
        if time.time() > deadline:
            raise TimeoutError(f"{len(got)} of {want} frames")
        data = sock.recv(65536)
        if not data:
            break
        dec.feed(data)
        got.extend(dec.frames())
    return got


def send_and_drain(sock, frame, n_want):
    sock.sendall(proto.encode(frame))
    return recv_frames(sock, proto.Decoder(), n_want)


@pytest.fixture
def server():
    srv = BridgeServer(session_factory=small_session)
    srv.start()
    yield srv
    srv.stop()


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mtype", list(jproto.MsgType), ids=lambda m: m.name)
def test_encode_bytes_equal_jax(mtype):
    rng = np.random.default_rng(int(mtype))
    payload = [float(x) for x in rng.normal(0.0, 10.0, int(mtype) + 2).astype(np.float32)]
    assert proto.MsgType(int(mtype)).name == mtype.name
    want = jproto.encode(jproto.Frame(mtype, payload))
    assert proto.encode(proto.Frame(proto.MsgType(int(mtype)), payload)) == want
    assert len(proto.MsgType) == len(jproto.MsgType) and proto.MAGIC == jproto.MAGIC


def test_decoder_splits_streams_like_jax():
    rng = np.random.default_rng(3)
    frames = [jproto.Frame(jproto.MsgType(int(t)), [float(x) for x in rng.normal(size=n)])
              for t, n in ((1, 27), (2, 7), (3, 3), (7, 0), (15, 35), (16, 12))]
    unknown = struct.pack("<III", jproto.MAGIC, 999, 1) + struct.pack("<f", 1.0)
    blob = b"\x00junk" + jproto.encode(frames[0]) + unknown + b"".join(
        jproto.encode(f) for f in frames[1:])
    for cut in (1, 7, 13, 64):
        jd, td = jproto.Decoder(), proto.Decoder()
        jout, tout = [], []
        for i in range(0, len(blob), cut):
            jd.feed(blob[i:i + cut])
            td.feed(blob[i:i + cut])
            jout.extend(jd.frames())
            tout.extend(td.frames())
        assert [(int(f.type), f.payload) for f in tout] == [(int(f.type), f.payload)
                                                            for f in jout]
        assert len(tout) == len(frames)


def test_split_robot_states_and_images_like_jax():
    payload = [float(x) for x in range(27)]
    assert proto.split_robot_states(payload) == jproto.split_robot_states(payload)
    with pytest.raises(ValueError):
        proto.split_robot_states(payload[:26])
    img = np.random.default_rng(0).uniform(0.5, 8.0, (6, 4)).astype(np.float32)
    frame = proto.encode_image(img, seq=3, t=1.25)
    assert proto.encode(frame) == jproto.encode(jproto.encode_image(img, seq=3, t=1.25))
    back, meta = proto.decode_image(frame)
    np.testing.assert_array_equal(back, img)
    assert meta == {"seq": 3, "t": 1.25}


# ---------------------------------------------------------------------------
# The sessions against the JAX sessions
# ---------------------------------------------------------------------------


def test_solver_session_matches_jax():
    """Three requests from a hovering state with the arm off home, the JAX
    key chains' draws fed to the port; then teleop, land, gripper and the
    telemetry, equal."""
    ap, dp = jax_small_params()
    js, ts = jserver.SolverSession(arm_params=ap, drone_params=dp), small_session()
    ka, kd = js._arm_state.key, js._drone_state.key
    state = hover_state(np.asarray(HOME) + 0.1)
    state[0], state[1] = 0.2, -0.1
    for i in range(3):
        ka, sa = jax.random.split(ka)
        kd, sd = jax.random.split(kd)
        za, zd = np.array(jax.random.normal(sa, (K, H, 7))), np.array(jax.random.normal(sd, (K, H, 3)))
        jr, tr = js.handle_states(state), ts.handle_states(state, z_arm=za, z_drone=zd)
        assert [f.type for f in tr] == [proto.MsgType.ROBOT_CMD, proto.MsgType.DRONE_POSE]
        tau_j = np.asarray(jr[0].payload)
        np.testing.assert_allclose(tr[0].payload, tau_j, rtol=0,
                                   atol=TOL_SOLVE * np.abs(tau_j).max(), err_msg=f"tau {i}")
        np.testing.assert_allclose(tr[1].payload, jr[1].payload, rtol=TOL_DRONE,
                                   atol=TOL_DRONE, err_msg=f"xdes {i}")
    for code in (1, 3, 6, 2):
        js.handle_teleop_uav(code)
        ts.handle_teleop_uav(code)
    for code in (1, 1, 4, 13, 15):
        js.handle_teleop_arm(code)
        ts.handle_teleop_arm(code)
    np.testing.assert_array_equal(ts.drone_target, js.drone_target)
    np.testing.assert_array_equal(ts.arm_nudge, js.arm_nudge)
    assert ts.gripper_cmd == js.gripper_cmd == 1.0
    js.handle_teleop_uav(9)
    ts.handle_teleop_uav(9)
    js.handle_states(state)
    ts.handle_states(state)
    assert ts.land and js.land
    np.testing.assert_array_equal(ts.drone_target, js.drone_target)
    jt, tt = js.telemetry(), ts.telemetry()
    assert tt.type == proto.MsgType.TELEMETRY and len(tt.payload) == 35
    np.testing.assert_array_equal(np.float32(tt.payload), np.float32(jt.payload))


def test_whole_body_session_matches_jax():
    """Three requests at K=64, H=8 on the JAX session's key chain, a
    teleop nudge and an EE_REACH goal between them (the targets reach the
    solve), within the bridge head's 2e-3."""
    _whole_body_session_requests(WB_K)


def test_whole_body_session_torch_backend_matches_jax_at_k500():
    """The session with backend="torch" at K=500 (a size the kernels
    refuse; the JAX session's own XLA solve) on the same three requests."""
    _whole_body_session_requests(500, backend="torch")


def _whole_body_session_requests(k, **session_kw):
    jp = jwb.position_mode_params(n_samples=k, n_horizon=WB_H)
    js = jserver.WholeBodySession(params=jp)
    ts = WholeBodySession(params=convert.params_from_dict(jcfg.to_dict(jp)), device="cpu",
                          **session_kw)
    key = js._carry.key
    state = hover_state(np.asarray(HOME) - 0.05)
    state[14], state[20] = 0.1, 0.05
    for i in range(3):
        if i == 1:
            js.handle_teleop_uav(1)
            ts.handle_teleop_uav(1)
        if i == 2:
            goal = [7.0, 1.0, 0.2, 0.4, 1.5]
            np.testing.assert_array_equal([f.payload for f in ts.actions.handle_goal(goal, ts)],
                                          [f.payload for f in js.actions.handle_goal(goal, js)])
            np.testing.assert_array_equal(ts.ee_position, np.float32([0.2, 0.4, 1.5]))
        key, sub = jax.random.split(key)
        z = np.array(jax.random.normal(sub, (k, WB_H, 11)))
        jr, tr = js.handle_states(state), ts.handle_states(state, z=z)
        got = np.concatenate([tr[0].payload, tr[1].payload])
        want = np.concatenate([jr[0].payload, jr[1].payload])
        np.testing.assert_allclose(got, want, rtol=TOL_HEAD, atol=TOL_HEAD, err_msg=f"request {i}")
    np.testing.assert_array_equal(np.float32(ts.telemetry().payload),
                                  np.float32(js.telemetry().payload))


def test_action_goals_drive_the_session_targets():
    """The action interface (actionlib semantics) on the port's session:
    EE_REACH sets the EE target through the session, WAYPOINT the drone
    target, LAND the land flag; cancel, preemption, feedback and results."""
    s = small_session()
    out = s.actions.handle_goal(action.goal_frame(4, action.Task.EE_REACH, [0.1, 0.2, 1.7]).payload,
                                s)
    assert out[0].payload[:2] == [4.0, float(action.ActionStatus.ACTIVE)]
    np.testing.assert_array_equal(s.ee_position, np.float32([0.1, 0.2, 1.7]))
    out = s.actions.handle_goal(action.goal_frame(5, action.Task.WAYPOINT, [1.0, 0.0, 2.0]).payload,
                                s)
    assert out[0].type == proto.MsgType.ACTION_RESULT
    assert out[0].payload[:2] == [4.0, float(action.ActionStatus.PREEMPTED)]
    np.testing.assert_array_equal(s.drone_target, np.float32([1.0, 0.0, 2.0]))
    s.actions.feedback_every = 1
    replies = s.handle_states(hover_state(HOME))
    assert replies[2].type == proto.MsgType.ACTION_FEEDBACK
    assert replies[2].payload[2] == pytest.approx(np.linalg.norm([1.0, 0.0, 0.1]), rel=1e-5)
    out = s.actions.handle_cancel(action.cancel_frame(5).payload, s)
    assert out[0].payload[:2] == [5.0, float(action.ActionStatus.CANCELED)]
    s.actions.handle_goal(action.goal_frame(6, action.Task.LAND).payload, s)
    assert s.land
    s.actions.handle_cancel([6.0], s)
    assert not s.land
    bad = s.actions.handle_goal([7.0, float(action.Task.EE_REACH), 0.1], s)
    assert s.actions.active.status == action.ActionStatus.ABORTED and len(bad) == 1


def test_ee_reach_goal_succeeds_on_the_measured_error():
    """An EE_REACH goal at the EE's own position (the head's L1 error, 0)
    succeeds after hold_ticks requests, with the result frame."""
    from quadrotor_manipulator_mppi_tpu_torch.models import chain as chain_mod, kinova
    from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

    s = small_session()
    s.actions.hold_ticks = 3
    q = torch.tensor(HOME)
    state = hover_state(HOME)
    pose = Pose.from_xyzw(torch.tensor(state[0:3]), torch.tensor(state[3:7]))
    ee, _ = chain_mod.forward_kinematics_posquat(kinova.chain(), q, base_pos=pose.position,
                                                 base_quat=pose.quat)
    s.actions.handle_goal([9.0, float(action.Task.EE_REACH)] + N(ee).tolist(), s)
    results = []
    for _ in range(3):
        results += [f for f in s.handle_states(state) if f.type == proto.MsgType.ACTION_RESULT]
    assert len(results) == 1 and results[0].payload[1] == float(action.ActionStatus.SUCCEEDED)
    assert results[0].payload[2] < 1e-5


# ---------------------------------------------------------------------------
# tests/test_bridge.py and tests/test_ros_adapter_parity.py on the port
# ---------------------------------------------------------------------------


def test_protocol_roundtrip_python():
    f = proto.Frame(proto.MsgType.ROBOT_STATES, [float(i) for i in range(27)])
    d = proto.Decoder()
    blob = proto.encode(f)
    d.feed(b"\x00\x01junk")
    d.feed(blob[:10])
    assert d.pop() is None
    d.feed(blob[10:])
    out = d.pop()
    assert out is not None and out.type == proto.MsgType.ROBOT_STATES
    np.testing.assert_allclose(out.payload, f.payload)


def test_decoder_skips_unknown_message_types():
    d = proto.Decoder()
    unknown = struct.pack("<III", proto.MAGIC, 999, 1) + struct.pack("<f", 1.0)
    d.feed(unknown + proto.encode(proto.Frame(proto.MsgType.PING, [])))
    f = d.pop()
    assert f is not None and f.type == proto.MsgType.PING
    assert d.pop() is None


def test_session_land_command_descends_target():
    s = small_session()
    s.handle_teleop_uav(9)
    assert s.land
    s.handle_states(hover_state())
    assert s.drone_target[2] < 2.1
    s.handle_teleop_arm(15)
    assert s.gripper_cmd == 1.0
    s.handle_teleop_arm(16)
    assert s.gripper_cmd == 0.0


def test_python_client_session():
    s = small_session()
    replies = s.handle_states(hover_state())
    assert replies[0].type == proto.MsgType.ROBOT_CMD
    assert replies[1].type == proto.MsgType.DRONE_POSE
    t0 = s.drone_target.copy()
    s.handle_teleop_uav(1)
    assert s.drone_target[0] == pytest.approx(t0[0] + 0.3)
    s.handle_teleop_uav(9)
    assert s.land
    s.handle_teleop_arm(1)
    assert s.arm_nudge[0] == pytest.approx(np.deg2rad(10))
    s.handle_teleop_arm(2)
    assert s.arm_nudge[0] == pytest.approx(0.0, abs=1e-6)


def test_server_round_trip_and_ping(server):
    with socket.create_connection((server.host, server.port), timeout=TIMEOUT) as c:
        got = send_and_drain(c, proto.Frame(proto.MsgType.ROBOT_STATES, hover_state(HOME)), 2)
        assert [f.type for f in got] == [proto.MsgType.ROBOT_CMD, proto.MsgType.DRONE_POSE]
        assert len(got[0].payload) == 7 and len(got[1].payload) == 3
        assert all(np.isfinite(got[0].payload)) and np.abs(got[0].payload).max() > 1e-3
        unknown = struct.pack("<III", proto.MAGIC, 999, 1) + struct.pack("<f", 1.0)
        c.sendall(unknown)
        got = send_and_drain(c, proto.Frame(proto.MsgType.PING, []), 1)
        assert got[0].type == proto.MsgType.PING
        img = np.arange(12, dtype=np.float32).reshape(3, 4)
        c.sendall(proto.encode(proto.encode_image(img, seq=1, t=0.5)))
        back, meta = proto.decode_image(send_and_drain(
            c, proto.Frame(proto.MsgType.IMAGE_REQ, []), 1)[0])
        np.testing.assert_array_equal(back, img)
        c.sendall(proto.encode(proto.Frame(proto.MsgType.RPYT, [0.1, 0.0, 0.2, 30.0])))
        send_and_drain(c, proto.Frame(proto.MsgType.PING, []), 1)
        np.testing.assert_allclose(server.session().rpyt, [0.1, 0.0, 0.2, 30.0], rtol=1e-6)


def test_monitor_telemetry_and_shared_session(server):
    with socket.create_connection((server.host, server.port), timeout=TIMEOUT) as plant, \
            socket.create_connection((server.host, server.port), timeout=TIMEOUT) as ui:
        got = send_and_drain(plant, proto.Frame(proto.MsgType.ROBOT_STATES, hover_state()), 2)
        assert [f.type for f in got[:2]] == [proto.MsgType.ROBOT_CMD, proto.MsgType.DRONE_POSE]
        tele = send_and_drain(ui, proto.Frame(proto.MsgType.MONITOR, []), 1)[0]
        assert tele.type == proto.MsgType.TELEMETRY and len(tele.payload) == 35
        assert tele.payload[2] == pytest.approx(2.1)
        t0 = tele.payload[27:30]
        ui.sendall(proto.encode(proto.Frame(proto.MsgType.TELEOP_UAV, [1.0])))
        deadline = time.time() + 10
        while time.time() < deadline:
            tele2 = send_and_drain(ui, proto.Frame(proto.MsgType.MONITOR, []), 1)[0]
            if abs(tele2.payload[27] - (t0[0] + 0.3)) < 1e-5:
                break
        assert tele2.payload[27] == pytest.approx(t0[0] + 0.3)
        # An action goal over the wire, answered on the same connection.
        got = send_and_drain(ui, action.goal_frame(2, action.Task.EE_REACH, [0.1, 0.3, 1.6]), 1)
        assert got[0].type == proto.MsgType.ACTION_FEEDBACK
        got = send_and_drain(ui, action.cancel_frame(2), 1)
        assert got[0].type == proto.MsgType.ACTION_RESULT
        np.testing.assert_allclose(server.session().ee_position, [0.1, 0.3, 1.6], rtol=1e-6)


def test_whole_body_session_contract():
    params = twb.position_mode_params(n_samples=64, n_horizon=16)
    s = WholeBodySession(params=params, device="cpu")
    replies = s.handle_states(hover_state())
    assert [f.type for f in replies] == [proto.MsgType.ROBOT_CMD, proto.MsgType.DRONE_POSE]
    tau, xdes = np.asarray(replies[0].payload), np.asarray(replies[1].payload)
    assert tau.shape == (7,) and np.all(np.isfinite(tau)) and np.all(np.abs(tau) < 50.0)
    assert xdes.shape == (3,) and np.all(np.isfinite(xdes)) and abs(xdes[2] - 2.1) < 1.0
    t0 = s.drone_target.copy()
    s.handle_teleop_uav(1)
    assert s.drone_target[0] == pytest.approx(t0[0] + 0.3)
    tele = s.telemetry()
    assert tele.type == proto.MsgType.TELEMETRY and len(tele.payload) == 35
    assert np.all(np.isfinite(np.asarray(s.handle_states(hover_state())[0].payload)))
    with pytest.raises(ValueError, match="position mode"):
        WholeBodySession(params=twb.WholeBodyMPPIParams(), device="cpu")


def test_ros_adapter_round_trip_against_live_server(server):
    cmds, poses = [], []
    sock = socket.create_connection((server.host, server.port), timeout=TIMEOUT)
    adapter = RosQmmAdapter(sock, cmds.append, poses.append)
    position = [0.0, 0.0, 2.1, 0.0, 0.0, 0.0, 1.0] + [0.0] * 7
    try:
        for i in range(3):
            adapter.on_robot_states(position, [0.0] * 13)
            deadline = time.time() + TIMEOUT
            while (len(cmds) <= i or len(poses) <= i) and time.time() < deadline:
                adapter.pump_once(timeout=0.5)
        assert len(cmds) >= 3 and len(poses) >= 3
        assert all(len(c) == 7 for c in cmds) and all(len(p) == 3 for p in poses)
        tau = np.asarray(cmds[-1])
        assert np.all(np.isfinite(tau)) and np.any(np.abs(tau) > 1e-3)
        assert np.all(np.isfinite(poses[-1]))
        assert adapter.frames_out == 3 and adapter.frames_in >= 6
    finally:
        adapter.stop()


def test_ros_adapter_ignores_short_messages():
    class DummySock:
        sent = b""

        def sendall(self, b):
            self.sent += b

    s = DummySock()
    adapter = RosQmmAdapter(s, lambda c: None, lambda p: None)
    adapter.on_robot_states([0.0] * 5, [0.0] * 3)
    assert s.sent == b""
    adapter.on_robot_states([0.0, 0.0, 2.1, 0.0, 0.0, 0.0, 1.0] + [0.0] * 7, [0.0] * 13)
    adapter.send_teleop_uav(5)
    dec = proto.Decoder()
    dec.feed(s.sent)
    frame = dec.pop()
    assert frame.type == proto.MsgType.ROBOT_STATES and len(frame.payload) == 27
    assert frame.payload[2] == pytest.approx(2.1)
    assert dec.pop().payload == [5.0]


# ---------------------------------------------------------------------------
# The sim adapter
# ---------------------------------------------------------------------------


def test_sim_adapter_closes_distributed_loop(server):
    """tests/test_bridge.py's gate: 0.3 s of the two-process loop, the plant
    airborne under the returned commands."""
    adapter = sim_adapter.SimAdapter(server.host, server.port, device="cpu")
    adapter._sock.settimeout(TIMEOUT)
    result = adapter.run(seconds=0.3)
    pos = result["pos"]
    assert pos.shape == (300, 3) and np.all(np.isfinite(pos))
    assert pos[-1, 2] > 1.5, f"lost altitude: {pos[-1]}"
    assert np.isfinite(result["final_setpoint"]).all()
    assert np.isfinite(result["q"]).all()


def test_sim_adapter_remainder_ticks_exchange_like_jax(server):
    """A run that is not a whole number of periods: 25 ticks make three
    exchanges (at ticks 0, 10 and 20), as the JAX loop's i % 10 == 0."""
    adapter = sim_adapter.SimAdapter(server.host, server.port, device="cpu")
    adapter._sock.settimeout(TIMEOUT)
    result = adapter.run(seconds=0.025)
    assert result["pos"].shape == (25, 3)
    assert server.session().latest_states is not None
    assert server.session()._head._state[0].step.item() == 3


@pytest.fixture(scope="module")
def dummy_listener():
    srv = socket.create_server(("127.0.0.1", 0))
    yield srv.getsockname()
    srv.close()


def _adapters(addr):
    """A JAX and a port adapter (the port's on the CPU) in one perturbed
    state: tilted, moving, the arm off home, a commanded effort and an
    offset setpoint."""
    rng = np.random.default_rng(11)
    ja = jsim.SimAdapter(*addr)
    ta = sim_adapter.SimAdapter(*addr, device="cpu")
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    quat = np.concatenate([[np.cos(0.05)], axis * np.sin(0.05)]).astype(np.float32)
    plant = ja.plant._replace(
        pos=jnp.asarray([0.1, -0.2, 2.2], jnp.float32), quat=jnp.asarray(quat),
        vel=jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32),
        omega=jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32))
    q = (np.asarray(HOME) + rng.normal(0, 0.05, 7)).astype(np.float32)
    qdot = rng.normal(0, 0.1, 7).astype(np.float32)
    tau = rng.normal(0, 2.0, 7).astype(np.float32)
    sp = np.float32([0.3, -0.1, 2.4])
    ja.plant, ja.q, ja.qdot = plant, jnp.asarray(q), jnp.asarray(qdot)
    ja.tau_arm = jnp.asarray(tau)
    ja.setpoint = jfc.hover_setpoint(jnp.asarray(sp))
    tplant = ta._carry[0]._replace(pos=T(plant.pos), quat=T(plant.quat), vel=T(plant.vel),
                                   omega=T(plant.omega), rotor_speed=T(plant.rotor_speed))
    ta._carry = (tplant, T(q), T(qdot), ta._carry[3])
    ta._cmd = T(np.concatenate([tau, sp]))
    return ja, ta


def _assert_same_state(ja, ta, tol, what):
    plant, q, qdot, ctrl = ta._carry
    pairs = [("pos", plant.pos, ja.plant.pos), ("quat", plant.quat, ja.plant.quat),
             ("vel", plant.vel, ja.plant.vel), ("omega", plant.omega, ja.plant.omega),
             ("rotor_speed", plant.rotor_speed, ja.plant.rotor_speed), ("q", q, ja.q),
             ("qdot", qdot, ja.qdot)]
    pairs += [(f"ctrl.{f}", getattr(ctrl, f), getattr(ja.ctrl, f)) for f in ctrl._fields]
    for name, got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(N(got), want, rtol=tol, atol=tol, err_msg=f"{what}: {name}")


def _jitted_tick(ja):
    """``tick()``: one call of the JAX adapter's own ``_tick`` on its
    attributes, compiled once with ``jax.jit`` (the eager JAX tick takes
    ~0.4 s on the CPU)."""
    def body(plant, q, qdot, ctrl, tau_arm, setpoint):
        ja.plant, ja.q, ja.qdot, ja.ctrl = plant, q, qdot, ctrl
        ja.tau_arm, ja.setpoint = tau_arm, setpoint
        ja._tick()
        return ja.plant, ja.q, ja.qdot, ja.ctrl

    compiled = jax.jit(body)

    def tick():
        # Strong dtypes, so the first call's weakly typed leaves do not
        # make a second compile.
        args = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype=x.dtype), (
            ja.plant, ja.q, ja.qdot, ja.ctrl, ja.tau_arm, ja.setpoint))
        ja.plant, ja.q, ja.qdot, ja.ctrl = compiled(*args)
        ja.tau_arm, ja.setpoint = args[4:]

    return tick


def test_sim_adapter_period_matches_jax_ticks(dummy_listener):
    """One control period of the port (ten ticks) against ten calls of the
    JAX adapter's tick from the same state, effort and setpoint (2e-4 per
    field), then 20 periods (5e-3)."""
    ja, ta = _adapters(dummy_listener)
    tick = _jitted_tick(ja)
    for n_periods, tol in ((1, TOL_PERIOD), (19, TOL_PERIODS)):
        for _ in range(n_periods):
            rows = ta._replay_period()
            jrows = []
            for _ in range(10):
                tick()
                jrows.append(np.asarray(ja.plant.pos))
            np.testing.assert_allclose(N(rows), np.stack(jrows), rtol=tol, atol=tol)
        _assert_same_state(ja, ta, tol, f"{n_periods} periods")


# ---------------------------------------------------------------------------
# The native tools against the port's server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """The native tools built into this module's own directory (never
    native/build, which tests/test_bridge.py builds into concurrently)."""
    if shutil.which("cmake") is None:
        pytest.skip("cmake not available")
    build = str(tmp_path_factory.mktemp("native_build"))
    subprocess.run(["cmake", "-S", NATIVE, "-B", build, "-DCMAKE_BUILD_TYPE=Release"],
                   check=True, capture_output=True, timeout=TIMEOUT)
    subprocess.run(["cmake", "--build", build, "-j", "2", "--target", "qmm_roundtrip_test",
                    "qmm_dashboard"], check=True, capture_output=True, timeout=TIMEOUT)
    return build


def test_native_roundtrip(native_build, server):
    out = subprocess.run([os.path.join(native_build, "qmm_roundtrip_test"), server.host,
                          str(server.port)], capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, f"stdout={out.stdout} stderr={out.stderr}"
    assert "robot_cmd:" in out.stdout and "drone_pose:" in out.stdout
    cmd_line = [ln for ln in out.stdout.splitlines() if ln.startswith("robot_cmd:")][0]
    taus = [float(x) for x in cmd_line.split()[1:]]
    assert len(taus) == 7 and all(abs(t) < 200 for t in taus)
    assert any(abs(t) > 1e-3 for t in taus)


def test_native_dashboard_once(native_build, server):
    """qmm_dashboard --once polls the port's live server and renders its
    telemetry."""
    with socket.create_connection((server.host, server.port), timeout=TIMEOUT) as plant:
        send_and_drain(plant, proto.Frame(proto.MsgType.ROBOT_STATES, hover_state()), 2)
        out = subprocess.run([os.path.join(native_build, "qmm_dashboard"), server.host,
                              str(server.port), "--once"], capture_output=True, text=True,
                             timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr
    assert "base pos" in out.stdout and "2.100" in out.stdout and "drone tgt" in out.stdout


def test_native_dashboard_camera_panel(native_build, server):
    """qmm_dashboard --once --camera: the port's CameraPublisher streams a
    depth frame to the server, and the dashboard polls it back (IMAGE_REQ)
    and draws the ASCII depth panel under the telemetry
    (tests/test_bridge.py's case on the port)."""
    from quadrotor_manipulator_mppi_tpu_torch.bridge.camera import CameraPublisher, fetch_image

    with socket.create_connection((server.host, server.port), timeout=TIMEOUT) as plant, \
            socket.create_connection((server.host, server.port), timeout=TIMEOUT) as cam:
        send_and_drain(plant, proto.Frame(proto.MsgType.ROBOT_STATES, hover_state()), 2)
        pub = CameraPublisher(cam, rate_hz=1000.0)
        assert pub.publish(np.linspace(0.5, 8.0, 24 * 32, dtype=np.float32).reshape(24, 32), t=1.25)
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:   # until the server has taken the frame
            with socket.create_connection((server.host, server.port), timeout=TIMEOUT) as v:
                img, _ = fetch_image(v)
                if img is not None and img.shape == (24, 32):
                    break
            time.sleep(0.05)
        out = subprocess.run([os.path.join(native_build, "qmm_dashboard"), server.host,
                              str(server.port), "--once", "--camera"], capture_output=True,
                             text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr
    assert "base pos" in out.stdout and "camera 32x24" in out.stdout
    assert any(g in out.stdout for g in "#%@") and "." in out.stdout
