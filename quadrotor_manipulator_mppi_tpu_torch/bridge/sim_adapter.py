"""Plant-side bridge adapter: drives the in-framework simulator against a
remote solver server over the QMM protocol.

Port of the JAX package's ``bridge/sim_adapter.py``.  It reproduces the
reference's process architecture (SURVEY.md sections 3.2-3.4): the plant
physics in one process (this adapter stepping the octorotor + arm plant at
1 kHz), the MPPI solvers in another (the bridge server), talking the
robot_states / robot_cmd / drone_pose topic contract over the wire.  It is
also the template for adapting a real plant or the original Gazebo sim:
implement the state read and the command write against your transport and
keep the loop.

The plant runs on ``device``.  One tick is the JAX adapter's: arm forward
dynamics under the base rotation (``rigid_body.forward_dynamics``), the arm
gravity moment, the backstepping law with its feed-forward, the allocation
and the multirotor step with the arm lump and the moment.  On the card the
``control_decimation`` ticks between two exchanges are captured as one CUDA
graph at construction, on static buffers of the plant and of the command
(the arm efforts and the setpoint position), and replayed per exchange; the
period's positions go into a preallocated log, read once at the end of
:meth:`SimAdapter.run`.  Each exchange reads the packed robot state back
once and writes the reply's command into the static buffer once.
``graph=False`` runs the same ticks eagerly; on the CPU they always are.

Usage:
    server = BridgeServer(...); server.start()
    adapter = SimAdapter(server.host, server.port)
    result = adapter.run(seconds=2.0)
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models import kinova, multirotor as mr, rigid_body as rb
from ..models.whole_body import arm_gravity_torque_fast
from ..sim import closed_loop as cl
from ..sim import flight_control as fc
from ..utils import graphs
from ..utils import rotations as rot
from ..utils.device import resolve_device
from . import protocol as proto

CMD_SIZE = 10  # arm efforts (7), setpoint position (3)


@dataclass
class SimAdapter:
    host: str
    port: int
    physics_dt: float = 0.001
    control_decimation: int = 10      # solver round trip every N physics ticks
    vehicle: mr.MultirotorParams = field(default_factory=mr.MultirotorParams)
    arm_mass_lump: float = 5.54
    device: Any = "cuda"
    graph: bool = True

    def __post_init__(self):
        dev = self._dev = resolve_device(self.device)
        self._spec = kinova.chain()
        self._inertials = kinova.inertials()
        self.gains = fc.FlightGains()
        # Plant state: full quaternion base + arm at home, rotors at hover.
        plant = mr.init_state(self.vehicle, pos=(0.0, 0.0, 2.1), device=dev)
        plant = plant._replace(rotor_speed=torch.full(
            (self.vehicle.n_rotors,), self.vehicle.hover_rotor_speed(self.arm_mass_lump),
            device=dev))
        carry = (plant, torch.tensor(kinova.Q_HOME, dtype=torch.float32, device=dev),
                 torch.zeros(7, device=dev),
                 fc.init_ctrl_state(self.vehicle.mass + self.arm_mass_lump, device=dev))
        # The command: zero efforts, hold the start position.
        cmd = torch.cat([torch.zeros(7, device=dev), plant.pos])
        self._cmd_host = torch.zeros(CMD_SIZE, dtype=torch.float32,
                                     pin_memory=dev.type == "cuda")
        # One warm-up call creates the constants and library handles a
        # capture cannot; each is a whole eager period (~0.2-0.35 s on the
        # card).  Thread-local capture: a server or another plant of this
        # process may use the card meanwhile.
        self._load = (graphs.graphed(self._period, dev, warmup=1,
                                     capture_error_mode="thread_local")
                      if self.graph and dev.type == "cuda" else None)
        if self._load is not None:
            g = self._load(carry, cmd)  # captured here, before the first exchange
            carry, cmd = g.args
        self._carry, self._cmd = carry, cmd
        self._sock = socket.create_connection((self.host, self.port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._decoder = proto.Decoder()

    # -- physics -------------------------------------------------------------

    def _tick(self, carry, cmd):
        """One physics tick under the command ``cmd`` (CMD_SIZE,)."""
        plant, q, qdot, ctrl = carry
        dt = self.physics_dt
        base_rot = rot.quat_to_matrix(plant.quat)
        qdd = rb.forward_dynamics(self._spec, self._inertials, q, qdot, cmd[:7],
                                  base_rot=base_rot)
        qdot = qdot + qdd * dt
        q = q + qdot * dt

        # Arm gravity moment: disturbs the base AND is fed forward to the
        # backstepping law — exactly the reference's manipulator handling
        # (controller.cpp harrier_grav_feedback into computeQuadControl).
        tau_g = arm_gravity_torque_fast(self._spec, self._inertials, q, base_rot)
        u, ctrl = fc.backstepping_step(
            self.gains, self.vehicle, ctrl, fc.hover_setpoint(cmd[7:10]),
            pos=plant.pos, vel_world=plant.vel, rpy=cl.rpy_of(plant),
            omega_body=plant.omega, dt=dt, tau_g=tau_g,
        )
        plant = mr.step(
            self.vehicle, plant, fc.allocate(self.vehicle, u), dt,
            extra_mass=self.arm_mass_lump,
            external_wrench_body=(torch.zeros_like(tau_g), tau_g),
        )
        return plant, q, qdot, ctrl

    def _period(self, carry, cmd) -> torch.Tensor:
        """One control period: ``control_decimation`` ticks, the carry
        updated in place; returns the positions after each tick."""
        state, rows = carry, []
        for _ in range(self.control_decimation):
            state = self._tick(state, cmd)
            rows.append(state[0].pos)
        graphs.copy_into(carry, state)
        return torch.stack(rows)

    def _replay_period(self) -> torch.Tensor:
        if self._load is None:
            return self._period(self._carry, self._cmd)
        return self._load(self._carry, self._cmd).replay()

    # -- wire helpers --------------------------------------------------------

    def _robot_states(self) -> proto.Frame:
        """Pack the reference's 14+13 state vector (controller.cpp:304-337),
        read back from the card in one copy."""
        plant, q, qdot, _ = self._carry
        vec = torch.cat([plant.pos, rot.quat_to_xyzw(plant.quat), q, plant.vel,
                         plant.omega, qdot]).cpu().numpy()
        return proto.Frame(proto.MsgType.ROBOT_STATES, [float(x) for x in vec])

    def _exchange(self) -> None:
        self._sock.sendall(proto.encode(self._robot_states()))
        host = self._cmd_host.numpy()
        got_cmd = got_pose = False
        while not (got_cmd and got_pose):
            data = self._sock.recv(4096)
            if not data:
                raise ConnectionError("solver server closed")
            self._decoder.feed(data)
            for f in self._decoder.frames():
                if f.type == proto.MsgType.ROBOT_CMD:
                    host[:7] = f.payload
                    got_cmd = True
                elif f.type == proto.MsgType.DRONE_POSE:
                    host[7:10] = f.payload
                    got_pose = True
        self._cmd.copy_(self._cmd_host, non_blocking=True)

    @property
    def setpoint(self) -> np.ndarray:
        """The setpoint position the flight controller holds (host copy)."""
        return self._cmd[7:10].cpu().numpy()

    def run(self, seconds: float) -> dict:
        n = int(round(seconds / self.physics_dt))
        dec = self.control_decimation
        log = torch.empty((n, 3), dtype=torch.float32, device=self._dev)
        for i in range(0, n - n % dec, dec):
            self._exchange()
            log[i:i + dec].copy_(self._replay_period())
        for i in range(n - n % dec, n):
            # The remainder, as the JAX loop runs it: exchange at
            # i % control_decimation == 0, then tick.
            if i % dec == 0:
                self._exchange()
            state = self._tick(self._carry, self._cmd)
            graphs.copy_into(self._carry, state)
            log[i].copy_(state[0].pos)
        self._sock.sendall(proto.encode(proto.Frame(proto.MsgType.SHUTDOWN, [])))
        self._sock.close()
        return {
            "pos": log.cpu().numpy(),
            "q": self._carry[1].cpu().numpy(),
            "final_setpoint": self.setpoint,
        }
