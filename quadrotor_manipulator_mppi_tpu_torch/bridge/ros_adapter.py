"""Reference-side (ROS/Gazebo) adapter for the QMM bridge.

Runs NEXT TO the original Gazebo simulation (a ROS Noetic machine with the
reference workspace) and splices the solver server into the reference's
own topic graph, replacing ``kinova.py`` + ``drone.py``:

* subscribes ``/harrierD7/robot_states`` (``sensor_msgs/JointState`` with
  the 14-position / 13-velocity layout of ``controller.cpp:304-337``) and
  streams each message as a 27-float ``ROBOT_STATES`` QMM frame;
* publishes returned ``ROBOT_CMD`` frames as ``JointState.effort`` on
  ``/harrierD7/robot_cmd`` (the arm torque contract, ``kinova.py:188-191``)
  and ``DRONE_POSE`` frames as ``std_msgs/Float64MultiArray`` on
  ``/harrierD7/drone_pose`` (``drone.py:239-241`` ->
  ``controller.cpp:667-673``).

Usage on the ROS machine (no PyTorch needed there — this module only uses
the stdlib + rospy):

    roslaunch aerial_manipulation aerial_manipulator.launch
    python3 -m quadrotor_manipulator_mppi_tpu_torch.bridge.ros_adapter \
        --host <gpu-host> --port 8765

with a ``BridgeServer`` (``bridge/server.py``) listening on the GPU host.
The same solver process can drive the in-framework plant
(``bridge/sim_adapter.py``) and the original Gazebo plant, so their
closed-loop trajectories can be compared under identical solver behavior
(``evaluation/parity.py``).

A copy of the JAX package's adapter (stdlib only), kept byte for byte in
its wire handling.  The translation core (:class:`RosQmmAdapter`) takes
plain publisher callables, so it is exercised against a live
``BridgeServer`` without ROS (tests/test_torch_bridge.py); ``main()`` wires
real rospy pubs/subs.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, List, Optional, Sequence

from . import protocol as proto


class RosQmmAdapter:
    """Topic<->QMM translation around one TCP connection to the solver.

    ``publish_cmd(efforts: list[7])`` and ``publish_pose(xyz: list[3])`` are
    transport-agnostic callables (rospy publishers in production, capture
    lists in tests).
    """

    def __init__(
        self,
        sock: socket.socket,
        publish_cmd: Callable[[List[float]], None],
        publish_pose: Callable[[List[float]], None],
    ) -> None:
        self._sock = sock
        self._publish_cmd = publish_cmd
        self._publish_pose = publish_pose
        self._decoder = proto.Decoder()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rx: Optional[threading.Thread] = None
        self.frames_out = 0
        self.frames_in = 0

    # -- Gazebo -> solver ----------------------------------------------------

    def on_robot_states(self, position: Sequence[float], velocity: Sequence[float]):
        """JointState callback body: 14 positions + 13 velocities -> one
        27-float ROBOT_STATES frame (the layouts already agree:
        [base xyz, base quat xyzw, q(7)] + [base v(6), qd(7)])."""
        if len(position) < 14 or len(velocity) < 13:
            return  # pre-arming partial states; guard against short messages
        payload = [float(x) for x in position[:14]] + [
            float(v) for v in velocity[:13]
        ]
        data = proto.encode(proto.Frame(proto.MsgType.ROBOT_STATES, payload))
        with self._lock:
            self._sock.sendall(data)
        self.frames_out += 1

    def send_teleop_uav(self, code: int) -> None:
        with self._lock:
            self._sock.sendall(
                proto.encode(proto.Frame(proto.MsgType.TELEOP_UAV, [float(code)]))
            )

    def send_teleop_arm(self, code: int) -> None:
        with self._lock:
            self._sock.sendall(
                proto.encode(proto.Frame(proto.MsgType.TELEOP_ARM, [float(code)]))
            )

    # -- solver -> Gazebo ----------------------------------------------------

    def pump_once(self, timeout: float = 1.0) -> int:
        """Receive and dispatch pending solver frames; returns frames seen."""
        self._sock.settimeout(timeout)
        try:
            data = self._sock.recv(65536)
        except socket.timeout:
            return 0
        if not data:
            raise ConnectionError("solver closed the bridge")
        self._decoder.feed(data)
        n = 0
        for frame in self._decoder.frames():
            self._dispatch(frame)
            n += 1
        return n

    def _dispatch(self, frame: proto.Frame) -> None:
        if frame.type == proto.MsgType.ROBOT_CMD and len(frame.payload) == 7:
            self._publish_cmd(frame.payload)
        elif frame.type == proto.MsgType.DRONE_POSE and len(frame.payload) == 3:
            self._publish_pose(frame.payload)
        # Action feedback/result frames are host-side telemetry; ignore here.
        self.frames_in += 1

    def start_rx(self) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                try:
                    self.pump_once(timeout=0.2)
                except (ConnectionError, OSError):
                    return

        self._rx = threading.Thread(target=loop, daemon=True)
        self._rx.start()
        return self._rx

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        finally:
            if self._rx is not None:
                self._rx.join(timeout=1.0)


def main(argv=None):  # pragma: no cover — requires a ROS runtime
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--namespace", default="/harrierD7")
    args = p.parse_args(argv)

    import rospy
    from sensor_msgs.msg import JointState
    from std_msgs.msg import Float64MultiArray

    rospy.init_node("qmm_ros_adapter")
    cmd_pub = rospy.Publisher(
        f"{args.namespace}/robot_cmd", JointState, queue_size=1
    )
    pose_pub = rospy.Publisher(
        f"{args.namespace}/drone_pose", Float64MultiArray, queue_size=1
    )

    def publish_cmd(efforts):
        msg = JointState()
        msg.header.stamp = rospy.Time.now()
        msg.effort = efforts
        cmd_pub.publish(msg)

    def publish_pose(xyz):
        pose_pub.publish(Float64MultiArray(data=xyz))

    sock = socket.create_connection((args.host, args.port))
    adapter = RosQmmAdapter(sock, publish_cmd, publish_pose)
    adapter.start_rx()
    rospy.Subscriber(
        f"{args.namespace}/robot_states",
        JointState,
        lambda m: adapter.on_robot_states(m.position, m.velocity),
        queue_size=1,
    )
    rospy.loginfo("qmm_ros_adapter bridging %s <-> %s:%d",
                  args.namespace, args.host, args.port)
    rospy.spin()
    adapter.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
