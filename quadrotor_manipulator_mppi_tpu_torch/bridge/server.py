"""Solver bridge server: hosts the port's MPPI solvers behind the QMM protocol.

Port of the JAX package's ``bridge/server.py``, the runtime replacement for
the reference's two Python ROS nodes (``kinova.py`` and ``drone.py``): a
plant (the in-framework simulator, a Gazebo adapter, or a real vehicle)
connects over TCP, streams ``ROBOT_STATES`` frames, and receives
``ROBOT_CMD`` (7 arm efforts) and ``DRONE_POSE`` (xyz setpoint) frames back
— the topic contract of ``controller.cpp:165-180``.  Teleop frames from the
native tools (``native/src/teleop_*.cpp``) adjust the targets.

Each session answers a request with one *session head*: a function of the
solver state, the 37-float input (the 27-float robot state, or the packed
observation, and the 10-float target: EE position, EE quaternion wxyz,
base target) that returns one flat reply.  On the card the head is
captured in a CUDA graph when the session is built (``utils/graphs``), on
static copies of the solver state and of the input buffer, and each
request replays it: the request's input goes to the card in one copy from
a pinned host buffer, the reply comes back in one copy, and nothing else
waits for the card.  The targets live on the host (NumPy), where teleop,
the land rule and action goals change them, and are written into the
input buffer on every request, so a captured step always reads the latest
ones.  ``graph=False`` runs the same head eagerly; on the CPU it is always
eager.

Threads (``BridgeServer``): one thread per connection, one session shared
by all of them.  The session is built on first use under the session lock,
its captures included, and every call that touches the card runs under
that lock, so the server's own threads never use the card during a
capture.  The head takes all its inputs from its own static buffers, so
it is captured in the thread-local mode (``utils/graphs``): other threads
of the process (a second server, an in-process plant, a HIL session) may
go on using the card while a session is built.  The ``RPYT`` and image
branches touch no tensor.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models import chain as chain_mod
from ..models import kinova, rigid_body as rb
from ..solver import arm as arm_solver
from ..solver import drone as drone_solver
from ..solver import serving, whole_body as wbs
from ..solver.mppi import device_counters
from ..utils import graphs
from ..utils import rotations as rot
from ..utils.device import resolve_device
from ..utils.pose import Pose
from . import protocol as proto
from .action import ActionManager, ActionStatus

TELEOP_STEP_M = 0.3          # uav_teleop_node nudge (+-0.3 m)
TELEOP_STEP_JOINT = np.deg2rad(10.0)  # robot_teleop_node nudge

STATE_SIZE = 27   # the ROBOT_STATES payload (or the packed observation)
TARGET_SIZE = 10  # EE position (3), EE quaternion wxyz (4), base target (3)
INPUT_SIZE = STATE_SIZE + TARGET_SIZE


class SessionHead:
    """``head(state, inp, *z) -> reply`` answered per request, on ``device``.

    ``head`` reads the solver state and the (INPUT_SIZE,) input tensor,
    updates the state in place and returns the reply tensor.  On the card
    (``graph=True``) it is captured at construction on ``first_input``
    (the warm-up calls launch, the state is then restored) and replayed
    per request; a call with explicit normals ``z`` of another structure
    gets a graph of its own, loaded with the live state.  ``__call__(vec,
    *z)`` makes one host-to-device copy of ``vec`` and one device-to-host
    copy of the reply, returned as float32 NumPy."""

    def __init__(self, head: Callable[..., torch.Tensor], state: Any, first_input: np.ndarray,
                 device: torch.device, graph: bool, n_z: int):
        self.device = device
        self._head = head
        self._state = state
        self._z_none = (None,) * n_z
        pin = device.type == "cuda"
        self._host = torch.zeros(INPUT_SIZE, dtype=torch.float32, pin_memory=pin)
        self._inp = torch.zeros(INPUT_SIZE, dtype=torch.float32, device=device)
        self._load = (graphs.graphed(head, device, capture_error_mode="thread_local")
                      if graph and device.type == "cuda" else None)
        if self._load is not None:
            self._stage(first_input)
            self._bind(self._z_none)

    def _stage(self, vec) -> None:
        self._host.numpy()[:] = vec
        self._inp.copy_(self._host, non_blocking=True)

    def _bind(self, z: tuple) -> graphs.GraphedStep:
        g = self._load(self._state, self._inp, *z)
        self._state, self._inp = g.args[0], g.args[1]
        return g

    def __call__(self, vec, *z) -> np.ndarray:
        z = tuple(None if x is None else torch.as_tensor(x, dtype=torch.float32,
                                                         device=self.device) for x in z)
        z = z + self._z_none[len(z):]
        self._stage(vec)
        if self._load is None:
            reply = self._head(self._state, self._inp, *z)
        else:
            reply = self._bind(z).replay()
        return reply.cpu().numpy()  # the request's one readback


class _Session:
    """What both sessions share: the host targets, teleop, the land rule,
    the action interface and the telemetry view."""

    def _init_targets(self, drone_target) -> None:
        target = arm_solver.default_target(device="cpu")
        self.ee_position = target.position.numpy().copy()
        self.ee_quat = target.quat.numpy().copy()
        self.drone_target = np.asarray(drone_target, np.float32)
        self.arm_nudge = np.zeros(7, np.float32)
        self.land = False
        self.gripper_cmd = 0.0
        self.actions = ActionManager()
        # Latest joystick flight command ([roll, pitch, yaw_rate, thrust],
        # rotors_joy_interface contract) for plant adapters flying in
        # attitude mode; None until a RPYT frame arrives.
        self.rpyt = None

    def set_ee_position(self, xyz) -> None:
        """The end-effector target position (an ``EE_REACH`` goal); the next
        request carries it to the solver."""
        self.ee_position = np.asarray(xyz, np.float32)[:3].copy()

    def _targets(self) -> np.ndarray:
        return np.concatenate([self.ee_position, self.ee_quat, self.drone_target]).astype(
            np.float32)

    def _land_rule(self, base_pos) -> None:
        # Land command (teleop code 9): descend toward the current xy at
        # a fixed rate, mirroring the reference's landing behavior
        # (controller.cpp Land: descend, cut motors near ground).
        if self.land:
            self.drone_target[0:2] = np.asarray(base_pos[:2], np.float32)
            self.drone_target[2] = max(0.0, float(base_pos[2]) - 0.4)

    def telemetry(self) -> proto.Frame:
        """Live session view for dashboards (MsgType.TELEMETRY layout)."""
        states = getattr(self, "latest_states", [0.0] * 27)
        payload = (
            list(states)
            + [float(x) for x in self.drone_target]
            + [float(x) for x in self.ee_position]
            + [1.0 if self.land else 0.0, float(self.gripper_cmd)]
        )
        return proto.Frame(proto.MsgType.TELEMETRY, payload)

    def handle_teleop_uav(self, code: int) -> None:
        """Reference gear_callback code table (controller.cpp:741-809)."""
        step = TELEOP_STEP_M
        if code == 1:
            self.drone_target[0] += step
        elif code == 2:
            self.drone_target[0] -= step
        elif code == 3:
            self.drone_target[1] += step
        elif code == 4:
            self.drone_target[1] -= step
        elif code == 5:
            self.drone_target[2] += step
        elif code == 6:
            self.drone_target[2] -= step
        elif code == 9:
            self.land = True

    def handle_teleop_arm(self, code: int) -> None:
        """Reference kinova_callback codes: odd/even pairs nudge joint
        +-10 deg (applied plant-side in the reference, controller.cpp:813+;
        here accumulated for plant adapters to consume, like the land flag).
        Codes 15/16 = gripper close/open command (plant adapters drive the
        aperture via sim/scenario.MissionState.gripper_cmd)."""
        if 1 <= code <= 14:
            joint = (code + 1) // 2 - 1
            sign = 1.0 if code % 2 == 1 else -1.0
            self.arm_nudge[joint] += sign * TELEOP_STEP_JOINT
        elif code == 15:
            self.gripper_cmd = 1.0
        elif code == 16:
            self.gripper_cmd = 0.0


def _hover_state() -> np.ndarray:
    """A ROBOT_STATES payload at rest: base at 2.1 m, identity attitude
    (xyzw), arm at zero — the input a session captures its head on."""
    state = np.zeros(STATE_SIZE, np.float32)
    state[2], state[6] = 2.1, 1.0
    return state


@dataclass
class SolverSession(_Session):
    """Per-server solver state: arm MPPI + drone MPPI + teleop targets.

    The session head computes, from the arm and drone solver states and
    the request's input, the arm solve with the reference's
    inertia-weighted tracking torque (``kinova.py:184``: tau = M (400
    (qdes - q) - 40 qd) + nle), the drone setpoint (``drone.py:239-241``:
    position only) and the measured end-effector L1 error that an active
    ``EE_REACH`` goal reads: reply = [tau (7), xdes (3), error (1)].  The
    error is computed on every request (the JAX session computes it only
    while a goal is active; the numbers are the same).

    The two solvers draw the Philox stream (``ops/sampling``) under seeds
    ``2 * seed`` (arm) and ``2 * seed + 1`` (drone); ``handle_states(...,
    z_arm=, z_drone=)`` takes their standard normals instead."""

    arm_params: arm_solver.ArmMPPIParams = field(default_factory=arm_solver.ArmMPPIParams)
    drone_params: drone_solver.DroneMPPIParams = field(
        default_factory=drone_solver.DroneMPPIParams)
    seed: int = 0
    device: Any = "cuda"
    graph: bool = True

    def __post_init__(self):
        dev = resolve_device(self.device)
        arm_step, arm_init = arm_solver.make_arm_solver(self.arm_params, device=dev)
        drone_step, drone_init = drone_solver.make_drone_solver(self.drone_params, device=dev)
        spec, inertials = kinova.chain(), kinova.inertials()

        def head(states, inp, z_arm=None, z_drone=None):
            arm_state, drone_state = states
            base_pos, q, base_v, qd = inp[0:3], inp[7:14], inp[14:20], inp[20:27]
            base_pose = Pose.from_xyzw(base_pos, inp[3:7])
            target = Pose(position=inp[27:30], quat=inp[30:34])
            out, arm_new = arm_step(arm_state, arm_solver.ArmObs(
                q=q, qdot=qd, base_pose=base_pose, target=target), z_arm)
            m = rb.mass_matrix(spec, inertials, q)
            nle = rb.nonlinear_effects(spec, inertials, q, qd,
                                       base_rot=rot.quat_to_matrix(base_pose.quat))
            tau = m @ (400.0 * (out.qdes - q) - 40.0 * qd) + nle
            dout, drone_new = drone_step(drone_state, drone_solver.DroneObs(
                x=base_pos, v=base_v[:3], target=inp[34:37]), z_drone)
            ee_pos, _ = chain_mod.forward_kinematics_posquat(
                spec, q, base_pos=base_pose.position, base_quat=base_pose.quat)
            err = torch.sum(torch.abs(ee_pos - target.position))
            graphs.copy_into(states, (arm_new, drone_new))
            return torch.cat([tau, dout.xdes, err[None]])

        self._init_targets(drone_solver.DEFAULT_TARGET)
        states = (device_counters(arm_init(2 * self.seed), dev),
                  device_counters(drone_init(2 * self.seed + 1), dev))
        self._head = SessionHead(head, states, np.concatenate([_hover_state(), self._targets()]),
                                 dev, self.graph, n_z=2)

    def handle_states(self, payload, z_arm=None, z_drone=None) -> list:
        """ROBOT_STATES -> [ROBOT_CMD frame, DRONE_POSE frame] (+ action
        frames while a goal is active)."""
        self.latest_states = list(payload)
        base_pos, _, _, _, _ = proto.split_robot_states(payload)
        self._land_rule(base_pos)
        reply = self._head(np.concatenate([np.asarray(payload, np.float32), self._targets()]),
                           z_arm, z_drone)
        replies = [
            proto.Frame(proto.MsgType.ROBOT_CMD, [float(t) for t in reply[:7]]),
            proto.Frame(proto.MsgType.DRONE_POSE, [float(x) for x in reply[7:10]]),
        ]
        goal = self.actions.active
        if goal is not None and goal.status == ActionStatus.ACTIVE:
            replies.extend(
                self.actions.on_tick(float(reply[10]), np.asarray(base_pos, np.float32))
            )
        return replies


@dataclass
class WholeBodySession(_Session):
    """Whole-body MPPI behind the same wire contract as SolverSession.

    One coupled solver replaces the reference's two independent nodes: the
    arm efforts go out as ROBOT_CMD (the ``kinova.py:184`` tracking law
    around the solver's qdes) and the base position carrot as DRONE_POSE,
    so any plant adapter that speaks the reference topics (the in-framework
    sim, the Gazebo-side ``ros_adapter``) gets whole-body control with no
    change on its side.  Position-cascade mode only (its base command is a
    position setpoint, which is the DRONE_POSE contract).

    The session head is the bridge head of ``solver/serving.make_bridge_step``
    (the solve, the tracking law, the carrot) on the packed observation and
    target; ``handle_states(..., z=)`` takes the solve's standard normals in
    place of the Philox draw under ``seed``.  ``backend="cuda"`` (the
    default) solves on the hand-written kernels; ``backend="torch"`` on the
    plain pipeline, the counterpart of the JAX session's ``"xla"`` (the JAX
    ``"pallas"`` is ``"cuda"`` here), for configurations the kernels
    refuse, such as K=500; either head is captured on the card."""

    params: Any = None
    seed: int = 0
    setpoint_lookahead: int = 10
    device: Any = "cuda"
    graph: bool = True
    backend: str = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        if self.params is None:
            self.params = wbs.position_mode_params(n_samples=512, n_horizon=50)
        bstep, binit = serving.make_bridge_step(
            self.params, setpoint_lookahead=self.setpoint_lookahead, device=dev, graph=False,
            backend=self.backend)

        def head(carry, inp, z=None):
            reply, new = bstep(carry, inp[:STATE_SIZE], inp[STATE_SIZE:], z)
            graphs.copy_into(carry, new)
            return reply

        self._init_targets([0.0, 0.0, 2.1])
        first = self._obs_vec(_hover_state())
        self._head = SessionHead(head, binit(self.seed), np.concatenate([first, self._targets()]),
                                 dev, self.graph, n_z=1)

    @staticmethod
    def _obs_vec(payload) -> np.ndarray:
        # Wire (reference xyzw quaternion, controller.cpp:312-315) -> the
        # packed obs contract (solver/serving layout, wxyz).
        base_pos, base_quat_xyzw, q, base_v, qd = proto.split_robot_states(list(payload))
        quat_wxyz = np.asarray(base_quat_xyzw, np.float32)[[3, 0, 1, 2]]
        return np.concatenate([
            np.asarray(base_pos, np.float32), quat_wxyz,
            np.asarray(q, np.float32),
            np.asarray(base_v[:3], np.float32),   # world vel (adapter contract)
            np.asarray(base_v[3:6], np.float32),  # body rates
            np.asarray(qd, np.float32),
        ])

    def handle_states(self, payload, z=None) -> list:
        self.latest_states = list(payload)
        self._land_rule(payload[0:3])
        reply = self._head(np.concatenate([self._obs_vec(payload), self._targets()]), z)
        return [
            proto.Frame(proto.MsgType.ROBOT_CMD, [float(t) for t in reply[:7]]),
            proto.Frame(proto.MsgType.DRONE_POSE, [float(x) for x in reply[7:10]]),
        ]


class BridgeServer:
    """Threaded TCP server around ONE shared session.

    The session is shared across connections (created lazily on first use,
    all handler calls serialized by a lock): the plant streams states on one
    connection while teleop tools and dashboards steer/observe the SAME
    controller state from theirs — the reference's one-controller /
    many-UI-nodes topic topology (``controller.cpp:165-180``).  One plant
    per server; run several servers for several plants.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 session_factory: Optional[Callable[[], Any]] = None):
        self._sock = socket.create_server((host, port))
        self.host, self.port = self._sock.getsockname()
        self._factory = session_factory or SolverSession
        self._threads = []
        self._stop = threading.Event()
        self._session = None
        # RLock: dispatch branches hold it while lazily building the
        # session (sess() -> session() re-acquires).
        self._session_lock = threading.RLock()
        # Latest camera frame (IMAGE payload) — held on the SERVER, not the
        # session, so camera publishers/viewers never trigger the lazy
        # (expensive, capturing) solver-session build.
        self._latest_image: list = []
        self._image_lock = threading.Lock()

    def session(self):
        with self._session_lock:
            if self._session is None:
                self._session = self._factory()
            return self._session

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _handle(self, conn: socket.socket) -> None:
        # Deferred: camera publishers/viewers (IMAGE/IMAGE_REQ/PING only)
        # must not pay the solver-session build.
        session = None

        def sess():
            nonlocal session
            if session is None:
                session = self.session()
            return session

        decoder = proto.Decoder()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with conn:
            while True:
                data = conn.recv(4096)
                if not data:
                    return
                decoder.feed(data)
                for frame in decoder.frames():
                    if frame.type == proto.MsgType.SHUTDOWN:
                        return
                    elif frame.type == proto.MsgType.ROBOT_STATES:
                        with self._session_lock:
                            replies = sess().handle_states(frame.payload)
                        for reply in replies:
                            conn.sendall(proto.encode(reply))
                    elif frame.type == proto.MsgType.TELEOP_UAV:
                        with self._session_lock:
                            sess().handle_teleop_uav(int(frame.payload[0]))
                    elif frame.type == proto.MsgType.TELEOP_ARM:
                        with self._session_lock:
                            sess().handle_teleop_arm(int(frame.payload[0]))
                    elif frame.type == proto.MsgType.ACTION_GOAL:
                        with self._session_lock:
                            s_ = sess()
                            replies = s_.actions.handle_goal(frame.payload, s_)
                        for reply in replies:
                            conn.sendall(proto.encode(reply))
                    elif frame.type == proto.MsgType.ACTION_CANCEL:
                        with self._session_lock:
                            s_ = sess()
                            replies = s_.actions.handle_cancel(frame.payload, s_)
                        for reply in replies:
                            conn.sendall(proto.encode(reply))
                    elif frame.type == proto.MsgType.RPYT:
                        sess().rpyt = np.asarray(frame.payload[:4], np.float32)
                    elif frame.type == proto.MsgType.MONITOR:
                        with self._session_lock:
                            tele = sess().telemetry()
                        conn.sendall(proto.encode(tele))
                    elif frame.type == proto.MsgType.IMAGE:
                        # Camera stream (gst-plugin analog): keep the latest
                        # frame for dashboard polls.
                        with self._image_lock:
                            self._latest_image = frame.payload
                    elif frame.type == proto.MsgType.IMAGE_REQ:
                        with self._image_lock:
                            img = self._latest_image
                        conn.sendall(proto.encode(
                            proto.Frame(proto.MsgType.IMAGE, img)
                        ))
                    elif frame.type == proto.MsgType.PING:
                        conn.sendall(proto.encode(proto.Frame(proto.MsgType.PING, [])))
