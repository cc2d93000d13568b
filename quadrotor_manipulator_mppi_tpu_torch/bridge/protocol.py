"""QMM bridge wire protocol — Python side of ``native/include/qmm/bridge.hpp``.

Length-prefixed little-endian frames replacing the reference's ROS-topic
transport (SURVEY.md section 5 "distributed communication backend"):
``[magic u32]["QMM1"][type u32][count u32][count * f32]``.

Message types mirror the reference topic contract
(``controller.cpp:165-180``); the robot_states payload mirrors its 14+13
state vector layout (``controller.cpp:304-337``: base xyz, base quat in
**xyzw** order, arm q(7); base v(6), arm qd(7)).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum
from typing import Iterator, List, Optional, Tuple

MAGIC = 0x514D4D31  # "QMM1"
_HEADER = struct.Struct("<III")


class MsgType(IntEnum):
    ROBOT_STATES = 1   # 27 floats
    ROBOT_CMD = 2      # 7 floats (arm joint efforts)
    DRONE_POSE = 3     # 3 floats (desired xyz)
    MOTOR_SPEED = 4    # 8 floats
    TELEOP_UAV = 5     # 1 float code
    TELEOP_ARM = 6     # 1 float code
    PING = 7
    SHUTDOWN = 8
    # Action interface (the reference's declared to-do, README.md:30-34 —
    # actionlib-style goal/feedback/result/cancel semantics; bridge/action.py):
    ACTION_GOAL = 9      # [goal_id, task, params...]
    ACTION_FEEDBACK = 10 # [goal_id, status, error]
    ACTION_RESULT = 11   # [goal_id, status, error]
    ACTION_CANCEL = 12   # [goal_id]
    # Joystick flight command (rotors_joy_interface's RollPitchYawrateThrust
    # contract, joy.cpp): [roll, pitch, yaw_rate, thrust].
    RPYT = 13
    # Dashboard observability (the rqt_rotors GUI analog): MONITOR polls,
    # TELEMETRY replies with the shared session's live view (35 floats:
    # latest 27-float robot_states + drone_target(3) + ee_target pos(3) +
    # [land flag, gripper_cmd]).
    MONITOR = 14
    TELEMETRY = 15
    # Camera-frame streaming (the gst-camera plugin analog,
    # rotors_gazebo_plugins/src/external/gazebo_gst_camera_plugin.cpp — that
    # plugin pushes RGB frames into an H.264/RTP/UDP pipeline; here frames
    # ride the QMM bridge as float payloads): IMAGE pushes
    # [seq, t, height, width, channels, pixels...], IMAGE_REQ polls the
    # latest stored frame (dashboard camera view).
    IMAGE = 16
    IMAGE_REQ = 17


@dataclass
class Frame:
    type: MsgType
    payload: List[float]


def encode(frame: Frame) -> bytes:
    return _HEADER.pack(MAGIC, int(frame.type), len(frame.payload)) + struct.pack(
        f"<{len(frame.payload)}f", *frame.payload
    )


class Decoder:
    """Incremental frame decoder with byte-level resync (matches the C++)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def pop(self) -> Optional[Frame]:
        buf = self._buf
        while True:
            if len(buf) < 12:
                return None
            magic, mtype, count = _HEADER.unpack_from(buf, 0)
            if magic != MAGIC or count > 1 << 20:
                del buf[0]
                continue
            total = 12 + 4 * count
            if len(buf) < total:
                return None
            payload = list(struct.unpack_from(f"<{count}f", buf, 12))
            del buf[:total]
            try:
                mt = MsgType(mtype)
            except ValueError:
                # Unknown type (newer peer / protocol skew): skip the whole
                # well-framed message instead of killing the connection.
                continue
            return Frame(type=mt, payload=payload)

    def frames(self) -> Iterator[Frame]:
        while True:
            f = self.pop()
            if f is None:
                return
            yield f


def split_robot_states(payload: List[float]) -> Tuple[list, list, list, list, list]:
    """27-float robot_states -> (base_pos(3), base_quat_xyzw(4), q(7), base_v(6), qd(7)).

    Same split the reference's update_joint applies (``mppi.py:196-200``:
    q_full[:7] base pose, q_full[7:] arm; v_full[:6]/[6:]).
    """
    if len(payload) != 27:
        raise ValueError(f"robot_states needs 27 floats, got {len(payload)}")
    base_pos = payload[0:3]
    base_quat_xyzw = payload[3:7]
    q = payload[7:14]
    base_v = payload[14:20]
    qd = payload[20:27]
    return base_pos, base_quat_xyzw, q, base_v, qd


def encode_image(image, seq: int = 0, t: float = 0.0) -> Frame:
    """Pack an (H, W) or (H, W, C) image into an IMAGE frame.

    Layout: ``[seq, t, height, width, channels, pixels row-major]``.  Depth
    images stream their raw float meters (NaN bad points survive the trip);
    the ~12 KB of a 64x48 depth frame is well inside the decoder's frame
    cap.

    Precision bound: ``seq`` and ``t`` ride as float32 payload values, so
    ``seq`` is exact up to 2^24 frames (~19 days at 10 Hz) and ``t`` keeps
    millisecond resolution up to ~4.6 h of episode time — ample for every
    in-framework stream; re-key the session for longer recordings.
    """
    import numpy as np

    arr = np.asarray(image, np.float32)
    if arr.ndim == 2:
        h, w, c = arr.shape[0], arr.shape[1], 1
    elif arr.ndim == 3:
        h, w, c = arr.shape
    else:
        raise ValueError(f"image must be 2-D or 3-D, got shape {arr.shape}")
    header = [float(seq), float(t), float(h), float(w), float(c)]
    return Frame(MsgType.IMAGE, header + [float(v) for v in arr.reshape(-1)])


def decode_image(frame: Frame):
    """IMAGE frame -> ``(image ndarray, meta dict)``; None for the empty
    placeholder a server returns before any frame arrived."""
    import numpy as np

    if frame.type != MsgType.IMAGE:
        raise ValueError(f"not an IMAGE frame: {frame.type}")
    if not frame.payload:
        return None, {}
    seq, t, h, w, c = frame.payload[:5]
    h, w, c = int(h), int(w), int(c)
    pixels = np.asarray(frame.payload[5:], np.float32)
    if pixels.size != h * w * c:
        raise ValueError(
            f"IMAGE payload mismatch: {pixels.size} pixels for {h}x{w}x{c}"
        )
    img = pixels.reshape((h, w) if c == 1 else (h, w, c))
    return img, {"seq": int(seq), "t": float(t)}
