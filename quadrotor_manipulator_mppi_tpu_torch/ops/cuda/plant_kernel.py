"""One control period of the whole-body plant on a hand-written CUDA kernel.

Port of the JAX package's ``ops/pallas/plant_kernel.py``.  The serving
configuration of ``sim/whole_body_loop`` (position mode, frozen arm
coefficients, free flight) runs its ``substeps`` 1 kHz physics steps in one
launch of :func:`plant_tick` (``csrc/plant_kernel.cu``), eight lanes of a
warp per vehicle row.  Its plain version, :func:`plant_tick_plain`, replays the same
substeps through ``sim/whole_body_loop.physics_tick`` (the ported
rigid-body, flight-control and multirotor functions); the CPU tests use it
and the on-card checks hold the kernel against it.

State vector layout (``STATE_SIZE`` floats):
    [0:3]   base world position        [3:7]   base quaternion wxyz
    [7:10]  base world velocity        [10:13] body rates
    [13:21] rotor speeds (8)           [21:28] arm q
    [28:35] arm qdot                   [35:38] ctrl int_err
    [38:41] ctrl prev_err              [41:44] ctrl m_hat
    [44:46] ctrl n_hat

Coefficient vector (``DYN_SIZE``): minv (49) | g_tau (21) | g_n (9) |
c_tau (343, C order, contracted as qd[j] * sum_k c_tau[i, j, k] qd[k]).
Command: [setpoint xyz, yaw_des].  Arm torque: (7,), held over the period.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ...models.multirotor import MultirotorState
from ...models.rigid_body import FrozenArmCoeffs
from ...sim import flight_control as fc
from ...sim import whole_body_loop as wbl
from ...utils import graphs
from ...utils.device import resolve_device
from . import build

Tensor = torch.Tensor

N_J = 7
N_R = 8
STATE_SIZE = 46
DYN_SIZE = 49 + 21 + 9 + 343
LANES = 8   # lanes per vehicle row (PT_LANES)
BLOCK = 64  # threads per block (PT_BLOCK)

_F = ctypes.c_float
_GAIN_NAMES = ("kp_x", "kp_y", "kp_z", "kd_x", "kd_y", "kd_z", "ki_x", "ki_y", "ki_z",
               "kp_roll", "kp_pitch", "kp_yaw", "kd_roll", "kd_pitch", "kd_yaw")


class PlantParams(ctypes.Structure):
    """Per-configuration constants passed to plant_tick by value — the C
    struct ``PlantParams`` field for field (all 4-byte, no padding)."""

    _fields_ = [
        ("substeps", ctypes.c_int), ("pad_", ctypes.c_int),
        *[(n, _F) for n in ("dt", "mass", "ixx", "iyy", "izz", "xlen", "ylen")],
        ("alloc", (_F * N_R) * 4),
        ("pinv", (_F * 4) * N_R),
        *[(n, _F) for n in ("a_up", "a_dn", "w_max", "c_drag", "c_roll", "ground_z")],
        ("q_lo", _F * N_J),
        ("q_hi", _F * N_J),
        *[(n, _F) for n in _GAIN_NAMES],
    ]


@dataclass(frozen=True, eq=False)
class PlantTickConfig:
    """A plant configuration compiled for the kernel: the by-value struct
    and the physics its plain version replays."""

    substeps: int
    struct: PlantParams
    physics: Any  # sim.whole_body_loop.PlantPhysics


def make_plant_config(vehicle, gains: "fc.FlightGains", spec, *, substeps: int = 10,
                      dt: float = 0.001, extra_mass: float) -> PlantTickConfig:
    s = PlantParams()
    s.substeps, s.dt = int(substeps), float(dt)
    s.mass = float(vehicle.mass) + float(extra_mass)
    s.ixx, s.iyy, s.izz = (float(v) for v in vehicle.inertia)
    s.xlen, s.ylen = float(vehicle.xlen), float(vehicle.ylen)
    for i, row in enumerate(vehicle.allocation_matrix()):
        for r, v in enumerate(row):
            s.alloc[i][r] = float(v)
    for r, row in enumerate(vehicle.allocation_pinv()):
        for i, v in enumerate(row):
            s.pinv[r][i] = float(v)
    s.a_up = float(np.exp(-dt / vehicle.time_constant_up))
    s.a_dn = float(np.exp(-dt / vehicle.time_constant_down))
    s.w_max = float(vehicle.max_rotor_speed)
    s.c_drag = float(vehicle.rotor_drag_coefficient)
    s.c_roll = float(vehicle.rolling_moment_coefficient)
    s.ground_z = float(vehicle.ground_z)
    for j in range(N_J):
        s.q_lo[j], s.q_hi[j] = float(spec.lower[j]), float(spec.upper[j])
    for name in _GAIN_NAMES:
        setattr(s, name, float(getattr(gains, name)))
    physics = wbl.PlantPhysics(vehicle=vehicle, spec=spec, dt=float(dt),
                               extra_mass=float(extra_mass), gains=gains)
    return PlantTickConfig(substeps=int(substeps), struct=s, physics=physics)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def pack_plant(plant: "wbl.WholeBodyPlant") -> Tensor:
    """WholeBodyPlant -> the (..., STATE_SIZE) state vector."""
    b, c = plant.base, plant.ctrl
    return torch.cat([b.pos, b.quat, b.vel, b.omega, b.rotor_speed, plant.q, plant.qdot,
                      c.int_err, c.prev_err, c.m_hat, c.n_hat], dim=-1).to(torch.float32)


def unpack_plant(vec: Tensor) -> "wbl.WholeBodyPlant":
    """State vector (..., STATE_SIZE) -> WholeBodyPlant (views of ``vec``)."""
    base = MultirotorState(pos=vec[..., 0:3], quat=vec[..., 3:7], vel=vec[..., 7:10],
                           omega=vec[..., 10:13], rotor_speed=vec[..., 13:21])
    ctrl = fc.FlightCtrlState(int_err=vec[..., 35:38], prev_err=vec[..., 38:41],
                              m_hat=vec[..., 41:44], n_hat=vec[..., 44:46])
    return wbl.WholeBodyPlant(base=base, q=vec[..., 21:28], qdot=vec[..., 28:35], ctrl=ctrl)


def pack_dyn(dyn: FrozenArmCoeffs) -> Tensor:
    """FrozenArmCoeffs -> the (..., DYN_SIZE) coefficient vector."""
    lead = dyn.minv.shape[:-2]
    return torch.cat([dyn.minv.reshape(lead + (-1,)), dyn.g_tau.reshape(lead + (-1,)),
                      dyn.g_n.reshape(lead + (-1,)), dyn.c_tau.reshape(lead + (-1,))],
                     dim=-1).to(torch.float32)


def unpack_dyn(vec: Tensor) -> FrozenArmCoeffs:
    """Coefficient vector -> the FrozenArmCoeffs fields the substeps read
    (minv, g_tau, g_n, c_tau); the others are None."""
    lead = vec.shape[:-1]
    return FrozenArmCoeffs(
        minv=vec[..., 0:49].reshape(lead + (N_J, N_J)),
        g_tau=vec[..., 49:70].reshape(lead + (N_J, 3)),
        g_n=vec[..., 70:79].reshape(lead + (3, 3)),
        c_tau=vec[..., 79:DYN_SIZE].reshape(lead + (N_J, N_J, N_J)),
        c_n=None, g_f=None, c_f=None, mass=None, chol=None,
    )


# ---------------------------------------------------------------------------
# The kernel wrapper and its plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load_library("plant_kernel")
    vp = ctypes.c_void_p
    lib.plant_tick_launch.argtypes = [ctypes.POINTER(PlantParams), vp, vp, vp, vp, vp,
                                      ctypes.c_int, vp]
    lib.plant_tick_launch.restype = ctypes.c_int
    return lib


def _check(t: Tensor, shape, device, name: str) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor of shape {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def plant_tick(pc: PlantTickConfig, state: Tensor, dyn: Tensor, cmd: Tensor,
               tau: Tensor) -> Tensor:
    """One control period for B vehicle rows: state (B, 46) or (46,), dyn
    (B, 422), cmd (B, 4), tau (B, 7) with the same leading shape; returns
    the next state, shaped like ``state``."""
    if state.device.type == "cpu":
        return plant_tick_plain(pc, state, dyn, cmd, tau)
    dev = state.device
    if state.dim() not in (1, 2):
        raise ValueError(f"state: expected (46,) or (B, 46), got {tuple(state.shape)}")
    lead = tuple(state.shape[:-1])
    n = lead[0] if lead else 1
    _check(state, lead + (STATE_SIZE,), dev, "state")
    _check(dyn, lead + (DYN_SIZE,), dev, "dyn")
    _check(cmd, lead + (4,), dev, "cmd")
    _check(tau, lead + (N_J,), dev, "tau")
    out = torch.empty_like(state)
    rc = _lib().plant_tick_launch(
        ctypes.byref(pc.struct), state.data_ptr(), dyn.data_ptr(), cmd.data_ptr(),
        tau.data_ptr(), out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"plant_tick launch failed with CUDA error {rc}")
    plant_tick.launches += 1
    return out


plant_tick.launches = 0
graphs.count_replays(plant_tick)


def plant_tick_plain(pc: PlantTickConfig, state: Tensor, dyn: Tensor, cmd: Tensor,
                     tau: Tensor) -> Tensor:
    """Plain version of :func:`plant_tick`: ``substeps`` calls of
    ``physics_tick``'s frozen-coefficient, position-mode branch."""
    plant, co = unpack_plant(state), unpack_dyn(dyn)
    for _ in range(pc.substeps):
        plant = wbl.physics_tick(pc.physics, plant, cmd, tau, co)
    return pack_plant(plant)


def sample_rows(vehicle, spec, inertials, n: int, seed: int = 0, device="cuda",
                extra_mass: float = 5.54):
    """``n`` random plant rows near hover for checking the kernel: states
    (n, 46) perturbed around the home posture by about what the serving
    loop sees (no rotor command reaches 0 or its maximum, where the square
    root or the clamp would magnify rounding), the frozen coefficients at
    each row's q (n, 422), setpoint commands (n, 4) and arm torques (n, 7).
    Drawn on the CPU from ``seed``, then moved to ``device``."""
    from ...models import kinova
    from ...models import rigid_body as rb

    g = torch.Generator().manual_seed(seed)

    def noise(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * torch.as_tensor(scale, dtype=torch.float32)

    pos = torch.tensor([0.0, 0.0, 2.1]) + noise(n, 3, scale=0.1)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0]) + noise(n, 4, scale=[0.0, 0.003, 0.003, 0.01])
    quat = quat / quat.norm(dim=-1, keepdim=True)
    lo, hi = torch.tensor(spec.lower) + 0.05, torch.tensor(spec.upper) - 0.05
    q = torch.tensor(kinova.Q_HOME) + noise(n, 7, scale=0.05)
    q = torch.minimum(torch.maximum(q, lo), hi).to(torch.float32)
    hover = vehicle.hover_rotor_speed(extra_mass)
    state = torch.cat([
        pos, quat, noise(n, 3, scale=0.05), noise(n, 3, scale=0.005),
        hover + noise(n, 8, scale=2.0), q, noise(n, 7, scale=0.1), noise(n, 3, scale=0.005),
        noise(n, 3, scale=0.01), vehicle.mass + extra_mass + noise(n, 3, scale=0.1),
        noise(n, 2, scale=0.002),
    ], dim=-1)
    dyn = pack_dyn(rb.frozen_arm_coeffs(spec, inertials, q))
    cmd = torch.cat([pos + noise(n, 3, scale=0.02), noise(n, 1, scale=0.01)], dim=-1)
    tau = noise(n, 7, scale=1.0)
    dev = resolve_device(device)
    return tuple(t.to(dev).contiguous() for t in (state, dyn, cmd, tau))


def make_plant_tick_kernel(vehicle, gains, spec, *, substeps: int = 10, dt: float = 0.001,
                           extra_mass: float, device="cuda"):
    """Build ``tick(state, dyn, cmd4, tau7) -> state'`` running ``substeps``
    physics steps of the position-mode serving plant in one launch.  The
    inputs must lie on ``device``; on the CPU the tick is the plain
    version."""
    dev = resolve_device(device)
    pc = make_plant_config(vehicle, gains, spec, substeps=substeps, dt=dt,
                           extra_mass=extra_mass)

    def tick(state: Tensor, dyn: Tensor, cmd4: Tensor, tau7: Tensor) -> Tensor:
        if state.device.type != dev.type:
            raise ValueError(f"plant tick built for {dev}, got a state on {state.device}")
        return plant_tick(pc, state, dyn, cmd4, tau7)

    return tick
