"""HIL (hardware-in-the-loop) session: the in-framework plant speaking
MAVLink over UDP — the runtime role of ``gazebo_mavlink_interface``.

Port of the JAX package's ``bridge/hil.py``.  The reference plugin sits
inside gzserver, streams ``HIL_SENSOR`` / ``HIL_STATE_QUATERNION`` to a
PX4-class autopilot over UDP and applies the ``HIL_ACTUATOR_CONTROLS`` it
receives to the rotors (``gazebo_mavlink_interface.cpp:407-717``).
:class:`HilSession` does the same around the port's multirotor plant: each
:meth:`HilSession.tick` steps the plant at the physics rate, emits the
sensor/state messages (ISA pressure, NWU->FRD conversions —
``bridge/mavlink.py``), polls the socket, and decodes actuator controls
into rotor-speed references via the ``(control + offset) * scaling +
zero_position`` pipeline.

The loop is paced by the host by nature (a socket per tick).  The plant
lives on ``device``: its step is one call of ``multirotor.step`` on a
static rotor-command buffer, captured in a CUDA graph on the card, written
only when a new actuator message arrives; the new state (with its
rotation matrix, computed beside it in float32) comes back once per tick,
and the messages are built from it on the host in float64 NumPy, as in
the JAX session.

Transport is a plain UDP datagram pair, like upstream; any
mavlink-speaking autopilot (PX4 SITL, QGroundControl, or the loopback
test controller in ``tests/test_torch_hil.py``) can sit on the other end.
"""

from __future__ import annotations

import socket
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import multirotor as mr
from ..utils import graphs
from ..utils import rotations as rot
from ..utils.device import resolve_device
from . import mavlink as mav
from .config import HilConfig


def _unpack(vec: np.ndarray) -> tuple:
    """The step's packed readback -> (pos, vel, quat, omega, rmat), float64."""
    v = np.asarray(vec, np.float64)
    return v[0:3], v[3:6], v[6:10], v[10:13], v[13:22].reshape(3, 3)


class HilSession:
    """One plant + one UDP peer; the plant on ``device`` (see the module
    docstring)."""

    def __init__(
        self,
        vehicle: Optional[mr.MultirotorParams] = None,
        config: HilConfig = None,
        bind: Tuple[str, int] = ("127.0.0.1", 0),
        peer: Optional[Tuple[str, int]] = None,
        device="cuda",
        graph: bool = True,
    ):
        self.device = resolve_device(device)
        self.vehicle = vehicle or mr.MultirotorParams()
        self.config = config or HilConfig()
        self.amap = mav.ActuatorMap.rotors(
            self.vehicle.n_rotors, self.vehicle.max_rotor_speed
        )
        self.rotor_cmd = np.zeros(self.vehicle.n_rotors)
        self._cmd_stale = False
        self.armed = False
        self.tick_count = 0
        self.seq = 0
        pin = self.device.type == "cuda"
        self._cmd_host = torch.zeros(self.vehicle.n_rotors, dtype=torch.float32, pin_memory=pin)
        plant = mr.init_state(self.vehicle, device=self.device)
        cmd = torch.zeros(self.vehicle.n_rotors, dtype=torch.float32, device=self.device)
        # Thread-local capture, as the bridge's other steps: a server of
        # this process may use the card meanwhile.
        self._load = (graphs.graphed(self._step, self.device, capture_error_mode="thread_local")
                      if graph and self.device.type == "cuda" else None)
        if self._load is not None:
            plant, cmd = self._load(plant, cmd).args  # captured here
        self.plant, self._cmd = plant, cmd
        self._host_state = _unpack(self._pack(plant).cpu().numpy())
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.sock.setblocking(False)
        self.peer = peer
        self.parser = mav.Parser()

    @property
    def address(self) -> Tuple[str, int]:
        return self.sock.getsockname()

    @staticmethod
    def _pack(plant: mr.MultirotorState) -> torch.Tensor:
        return torch.cat([plant.pos, plant.vel, plant.quat, plant.omega,
                          rot.quat_to_matrix(plant.quat).reshape(9)])

    def _step(self, plant: mr.MultirotorState, cmd: torch.Tensor) -> torch.Tensor:
        """One physics step in place; returns the packed new state."""
        new = mr.step(self.vehicle, plant, cmd, self.config.physics_dt)
        graphs.copy_into(plant, new)
        return self._pack(plant)

    def _send(self, name: str, values: dict) -> None:
        if self.peer is None:
            return
        frame = mav.encode(
            name, values, seq=self.seq, sysid=self.config.sysid,
            compid=self.config.compid,
        )
        self.seq = (self.seq + 1) & 0xFF
        self.sock.sendto(frame, self.peer)

    def _poll(self) -> None:
        while True:
            try:
                data, addr = self.sock.recvfrom(4096)
            except BlockingIOError:
                return
            if self.peer is None:
                self.peer = addr
            for name, msg in self.parser.push(data):
                if name == "HIL_ACTUATOR_CONTROLS":
                    refs, armed = mav.decode_actuator_controls(msg, self.amap)
                    self.rotor_cmd, self.armed = refs, armed
                    self._cmd_stale = True

    def tick(self) -> None:
        """One physics step + message exchange."""
        cfg = self.config
        self._poll()
        if self._cmd_stale:
            # The pinned buffer is free: the last tick's readback waited for
            # the copy out of it.
            self._cmd_host.numpy()[:] = self.rotor_cmd
            self._cmd.copy_(self._cmd_host, non_blocking=True)
            self._cmd_stale = False
        prev_vel = self._host_state[1]
        if self._load is None:
            packed = self._step(self.plant, self._cmd)
        else:
            packed = self._load(self.plant, self._cmd).replay()
        self._host_state = pos, vel, quat, omega, rmat = _unpack(packed.cpu().numpy())
        self.tick_count += 1
        t_usec = int(self.tick_count * cfg.physics_dt * 1e6)

        if self.tick_count % cfg.sensor_interval == 0:
            # specific force in body frame: R^T (a - g), NWU
            acc_w = (vel - prev_vel) / cfg.physics_dt
            f_spec = rmat.T @ (acc_w - np.array([0.0, 0.0, -mr.GRAVITY]))
            # Local geomagnetic field at the home fix: WMM magnetic-north
            # components rotated by the table declination (the plugin's
            # per-fix q_dn rotation) — NED -> NWU flips E and D.
            mag_ned = mav.mag_field_ned(cfg.lat_deg, cfg.lon_deg)
            mag_b = rmat.T @ np.array(
                [mag_ned[0], -mag_ned[1], -mag_ned[2]]
            )
            self._send(
                "HIL_SENSOR",
                mav.hil_sensor_values(
                    time_usec=t_usec,
                    accel_body_nwu=f_spec,
                    gyro_body_nwu=omega,
                    mag_body_nwu=mag_b,
                    alt_amsl=cfg.alt_home + pos[2],
                    airspeed_body_x=float((rmat.T @ vel)[0]),
                ),
            )

        if self.tick_count % cfg.state_interval == 0:
            # NWU world / body -> NED / FRD: flip y, z of world vectors and
            # the matching quaternion conjugation (q_ng/q_br of :410-417).
            vel_ned = np.array([vel[0], -vel[1], -vel[2]])
            # quaternion NWU->NED: q_ned = q_flip * q * q_flip with
            # q_flip = (0, 1, 0, 0) — componentwise: (w, x, -y, -z).
            q_ned = np.array([quat[0], quat[1], -quat[2], -quat[3]])
            acc_b = rmat.T @ ((vel - prev_vel) / cfg.physics_dt)
            self._send(
                "HIL_STATE_QUATERNION",
                mav.hil_state_quaternion_values(
                    time_usec=t_usec,
                    quat_wxyz_ned=q_ned,
                    omega_body_frd=mav.nwu_to_frd(omega),
                    lat_deg=cfg.lat_deg,
                    lon_deg=cfg.lon_deg,
                    alt_m=cfg.alt_home + pos[2],
                    vel_ned=vel_ned,
                    accel_body_frd=mav.nwu_to_frd(acc_b),
                    true_airspeed=float(np.linalg.norm(vel)),
                ),
            )

    def close(self) -> None:
        self.sock.close()
