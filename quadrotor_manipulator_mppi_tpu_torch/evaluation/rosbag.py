"""Pure-Python rosbag (v2.0) reader and bag -> npz trajectory converter.

A copy of the JAX package's ``evaluation/rosbag.py`` (host code: the
standard library and NumPy).  It parses the rosbag 2.0 container directly
(length-prefixed records, bz2/none chunk compression, connection records
carrying md5/msgdef) with no ROS dependency, and deserializes the message
types on the reference's recording path:

* ``sensor_msgs/JointState`` — the 14-position / 13-velocity robot-state
  vector the reference's plant controller publishes (base xyz, base
  quaternion xyzw, 7 arm joints; velocities: base linear, base angular,
  arm);
* ``nav_msgs/Odometry`` — the RotorS odometry plugin's output;
* ``geometry_msgs/PoseStamped`` / ``PoseWithCovarianceStamped`` /
  ``TransformStamped`` / ``TwistStamped`` — the ground-truth topics;
* ``mav_msgs/Actuators`` — motor-speed commands.

``bag_to_npz`` maps a recorded flight onto the npz schema the
``--save-log`` path writes (keys ``t/pos/quat_xyzw/vel/...``), so
``python -m quadrotor_manipulator_mppi_tpu_torch.evaluation.parity compare
ref.bag ours.npz`` works end to end.

    python -m quadrotor_manipulator_mppi_tpu_torch.evaluation.rosbag topics run.bag
    python -m quadrotor_manipulator_mppi_tpu_torch.evaluation.rosbag convert run.bag run.npz
"""

from __future__ import annotations

import argparse
import bz2
import json
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# Record opcodes (rosbag format 2.0).
OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

MAGIC = b"#ROSBAG V2.0\n"


def _fields(buf: bytes) -> Dict[str, bytes]:
    """Parse a length-prefixed ``name=value`` field block."""
    out: Dict[str, bytes] = {}
    i, n = 0, len(buf)
    while i + 4 <= n:
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        if flen == 0 or i + flen > n:
            break
        name, _, value = buf[i : i + flen].partition(b"=")
        out[name.decode()] = value
        i += flen
    return out


def _records(buf: bytes, start: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    """Iterate ``(header_fields, data)`` records; stops at the first
    malformed record (trailing index padding in some writers)."""
    i, n = start, len(buf)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        if hlen == 0 or i + 4 + hlen + 4 > n:
            return
        header = _fields(buf[i + 4 : i + 4 + hlen])
        i += 4 + hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        if i + 4 + dlen > n:
            return
        data = buf[i + 4 : i + 4 + dlen]
        i += 4 + dlen
        if "op" not in header:
            return
        yield header, data


class Connection:
    __slots__ = ("topic", "msg_type", "md5sum")

    def __init__(self, topic: str, msg_type: str, md5sum: str):
        self.topic = topic
        self.msg_type = msg_type
        self.md5sum = md5sum


def read_messages(
    path: str, topics: Optional[List[str]] = None
) -> Iterator[Tuple[str, str, float, bytes]]:
    """Yield ``(topic, msg_type, t_seconds, raw_serialized_bytes)`` for every
    message-data record (chunked or top-level), in file order."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise ValueError(f"{path}: not a rosbag 2.0 file")
    conns: Dict[int, Connection] = {}
    want = set(topics) if topics else None

    def handle(header: Dict[str, bytes], payload: bytes):
        op = header["op"][0]
        if op == OP_CONNECTION:
            (cid,) = struct.unpack("<I", header["conn"])
            sub = _fields(payload)
            conns[cid] = Connection(
                header["topic"].decode(),
                sub.get("type", b"").decode(),
                sub.get("md5sum", b"").decode(),
            )
        elif op == OP_MSG:
            (cid,) = struct.unpack("<I", header["conn"])
            (t_ns,) = struct.unpack("<Q", header["time"])
            # rosbag packs time as (secs u32, nsecs u32) little-endian.
            secs = t_ns & 0xFFFFFFFF
            nsecs = t_ns >> 32
            conn = conns.get(cid)
            if conn is None:
                return None
            if want is not None and conn.topic not in want:
                return None
            return conn.topic, conn.msg_type, secs + 1e-9 * nsecs, payload
        return None

    for header, payload in _records(data, len(MAGIC)):
        op = header["op"][0]
        if op == OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "bz2":
                payload = bz2.decompress(payload)
            elif comp == "lz4":
                try:
                    import lz4.frame  # optional; not on the control path
                except ImportError as e:  # pragma: no cover
                    raise RuntimeError("bag uses lz4 chunks; lz4 unavailable") from e
                payload = lz4.frame.decompress(payload)
            elif comp != "none":
                raise ValueError(f"unknown chunk compression {comp!r}")
            for h2, d2 in _records(payload):
                out = handle(h2, d2)
                if out is not None:
                    yield out
        elif op in (OP_CONNECTION, OP_MSG):
            out = handle(header, payload)
            if out is not None:
                yield out


# ---------------------------------------------------------------------------
# Minimal deserializers for the message types on the recording path.
# ROS serialization: little-endian, packed, arrays length-prefixed (u32),
# strings length-prefixed (u32, no NUL).
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.i : self.i + n]
        self.i += n
        return s.decode(errors="replace")

    def f64(self, n: int = 1) -> np.ndarray:
        out = np.frombuffer(self.buf, "<f8", count=n, offset=self.i)
        self.i += 8 * n
        return out

    def f64_array(self) -> np.ndarray:
        return self.f64(self.u32())

    def header(self) -> float:
        self.u32()  # seq
        secs, nsecs = self.u32(), self.u32()
        self.string()  # frame_id
        return secs + 1e-9 * nsecs


def parse_joint_state(raw: bytes) -> dict:
    """``sensor_msgs/JointState`` -> stamp/name/position/velocity/effort."""
    r = _Reader(raw)
    stamp = r.header()
    names = [r.string() for _ in range(r.u32())]
    return {
        "stamp": stamp,
        "name": names,
        "position": r.f64_array(),
        "velocity": r.f64_array(),
        "effort": r.f64_array(),
    }


def _pose(r: _Reader) -> Tuple[np.ndarray, np.ndarray]:
    return r.f64(3).copy(), r.f64(4).copy()  # position, quaternion xyzw


def _twist(r: _Reader) -> Tuple[np.ndarray, np.ndarray]:
    return r.f64(3).copy(), r.f64(3).copy()  # linear, angular


def parse_odometry(raw: bytes) -> dict:
    """``nav_msgs/Odometry`` -> stamp/pos/quat_xyzw/vel/omega."""
    r = _Reader(raw)
    stamp = r.header()
    r.string()  # child_frame_id
    pos, quat = _pose(r)
    r.f64(36)  # pose covariance
    vel, omega = _twist(r)
    return {"stamp": stamp, "pos": pos, "quat_xyzw": quat, "vel": vel, "omega": omega}


def parse_pose_stamped(raw: bytes) -> dict:
    r = _Reader(raw)
    stamp = r.header()
    pos, quat = _pose(r)
    return {"stamp": stamp, "pos": pos, "quat_xyzw": quat}


def parse_pose_with_cov_stamped(raw: bytes) -> dict:
    r = _Reader(raw)
    stamp = r.header()
    pos, quat = _pose(r)
    return {"stamp": stamp, "pos": pos, "quat_xyzw": quat}


def parse_transform_stamped(raw: bytes) -> dict:
    r = _Reader(raw)
    stamp = r.header()
    r.string()  # child_frame_id
    pos = r.f64(3).copy()
    quat = r.f64(4).copy()
    return {"stamp": stamp, "pos": pos, "quat_xyzw": quat}


def parse_twist_stamped(raw: bytes) -> dict:
    r = _Reader(raw)
    stamp = r.header()
    vel, omega = _twist(r)
    return {"stamp": stamp, "vel": vel, "omega": omega}


def parse_actuators(raw: bytes) -> dict:
    """``mav_msgs/Actuators`` (angles / angular_velocities / normalized)."""
    r = _Reader(raw)
    stamp = r.header()
    return {
        "stamp": stamp,
        "angles": r.f64_array(),
        "angular_velocities": r.f64_array(),
        "normalized": r.f64_array(),
    }


PARSERS = {
    "sensor_msgs/JointState": parse_joint_state,
    "nav_msgs/Odometry": parse_odometry,
    "geometry_msgs/PoseStamped": parse_pose_stamped,
    "geometry_msgs/PoseWithCovarianceStamped": parse_pose_with_cov_stamped,
    "geometry_msgs/TransformStamped": parse_transform_stamped,
    "geometry_msgs/TwistStamped": parse_twist_stamped,
    "mav_msgs/Actuators": parse_actuators,
}


def list_topics(path: str) -> Dict[str, Tuple[str, int]]:
    """``{topic: (msg_type, message_count)}`` for a bag."""
    out: Dict[str, Tuple[str, int]] = {}
    for topic, msg_type, _, _ in read_messages(path):
        ty, n = out.get(topic, (msg_type, 0))
        out[topic] = (ty, n + 1)
    return out


def bag_to_npz(
    bag_path: str,
    npz_path: str,
    topic: Optional[str] = None,
    mav_name: str = "harrierD7",
) -> dict:
    """Convert one trajectory topic of a bag into the framework's npz log
    schema (keys ``t``, ``pos``, ``quat_xyzw``, and whatever else the
    message type carries: ``vel``/``omega``/``q``/``qdot``).

    With no explicit ``topic``, picks the first match in preference order:
    ``/<mav>/robot_states`` (the reference plant's 14/13 JointState,
    ``controller.cpp:304-337``), then any Odometry, then any pose-typed
    topic — mirroring ``rosbag_tools/helpers.py``'s topic defaults.
    Returns a summary dict (topic, type, rows, written keys).
    """
    # Single pass: build the topic table AND buffer candidate trajectory
    # messages as we go (a second read_messages pass would re-decompress
    # every bz2 chunk — the dominant cost on real flight bags).  Memory is
    # bounded to PARSERS-typed messages (or just the requested topic).
    topics: Dict[str, Tuple[str, int]] = {}
    buffered: Dict[str, list] = {}
    for tp, ty, _, raw in read_messages(bag_path):
        prev_ty, n = topics.get(tp, (ty, 0))
        topics[tp] = (prev_ty, n + 1)
        if (topic is None and ty in PARSERS) or tp == topic:
            buffered.setdefault(tp, []).append(raw)
    if topic is None:
        prefer = [f"/{mav_name}/robot_states"]
        prefer += [t for t, (ty, _) in topics.items() if ty == "nav_msgs/Odometry"]
        prefer += [
            t
            for t, (ty, _) in topics.items()
            if ty
            in (
                "geometry_msgs/PoseStamped",
                "geometry_msgs/PoseWithCovarianceStamped",
                "geometry_msgs/TransformStamped",
            )
        ]
        topic = next((t for t in prefer if t in topics), None)
        if topic is None:
            raise ValueError(
                f"no trajectory topic found; bag has: "
                f"{ {t: ty for t, (ty, _) in topics.items()} }"
            )
    if topic not in topics:
        raise ValueError(
            f"no messages on {topic!r}; bag has "
            f"{ {t: ty for t, (ty, _) in topics.items()} }"
        )
    msg_type = topics[topic][0]
    parser = PARSERS.get(msg_type)
    if parser is None:
        raise ValueError(f"unsupported message type {msg_type!r} on {topic!r}")
    rows = [parser(raw) for raw in buffered.get(topic, [])]
    if not rows:
        raise ValueError(f"no messages on {topic!r}")

    out: Dict[str, np.ndarray] = {
        "t": np.asarray([m["stamp"] for m in rows], np.float64)
    }
    if msg_type == "sensor_msgs/JointState" and len(rows[0]["position"]) >= 14:
        # The reference's robot_states layout (controller.cpp:304-337):
        # positions = [base xyz, base quat xyzw, arm q(7)],
        # velocities = [base lin(3), base ang(3), arm qdot(7)].
        p = np.stack([m["position"] for m in rows])
        out["pos"] = p[:, 0:3]
        out["quat_xyzw"] = p[:, 3:7]
        out["q"] = p[:, 7:14]
        v = np.stack(
            [
                np.pad(m["velocity"], (0, max(0, 13 - len(m["velocity"]))))
                for m in rows
            ]
        )
        out["vel"] = v[:, 0:3]
        out["omega"] = v[:, 3:6]
        out["qdot"] = v[:, 6:13]
    else:
        for key in ("pos", "quat_xyzw", "vel", "omega", "position"):
            if key in rows[0]:
                out[key] = np.stack([m[key] for m in rows])
    np.savez(npz_path, **out)
    return {
        "bag": bag_path,
        "topic": topic,
        "msg_type": msg_type,
        "rows": len(rows),
        "keys": sorted(out.keys()),
        "npz": npz_path,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)
    info = sub.add_parser("topics", help="list a bag's topics")
    info.add_argument("bag")
    conv = sub.add_parser("convert", help="bag -> npz trajectory log")
    conv.add_argument("bag")
    conv.add_argument("npz")
    conv.add_argument("--topic", default=None)
    conv.add_argument("--mav-name", default="harrierD7")
    args = p.parse_args(argv)
    if args.mode == "topics":
        out = {t: {"type": ty, "count": n} for t, (ty, n) in list_topics(args.bag).items()}
    else:
        out = bag_to_npz(args.bag, args.npz, topic=args.topic, mav_name=args.mav_name)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
