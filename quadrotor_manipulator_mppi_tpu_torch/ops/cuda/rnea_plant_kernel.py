"""One control period of the exact whole-body plant on a hand-written CUDA kernel.

The whole-body loop's default plant (``sim/whole_body_loop``,
``arm_coeffs_per_control`` off: the reach gates, pick_weight,
``whole-body-full``) runs ``substeps`` 1 kHz physics steps per control
step, each a full RNEA forward dynamics of the arm under the tilted gravity
field beside the vehicle's step.  :func:`rnea_plant_period` runs the whole
period in one launch of ``rnea_plant_kernel<MODE, MM_ONCE>``
(``csrc/rnea_plant_kernel.cu``), eight lanes of a warp per vehicle row, in
every control mode (attitude, position, wrench), with the factor of M taken
once per period (``mass_matrix_per_control``) or every substep, a grasped
payload on link 7 and an external body wrench held over the period.  It
replaces no TPU kernel: the JAX package leaves this plant to XLA's substep
scan.  Its plain version, :func:`rnea_plant_period_plain`, is the substep
loop of ``physics_tick`` that the loop runs everywhere else (the CPU,
``backend="torch"``, the frozen-coefficient plant); the on-card checks hold
the kernel against it.

The state travels in the plant-tick kernel's 46-float layout
(``ops/cuda/plant_kernel``'s docstring): base position, quaternion,
velocity, body rates, rotor speeds, arm q and qdot, then the backstepping
controller's state, which only position mode changes.  The command is the
loop's base command (attitude: [T, roll, pitch, yaw]; position: [x, y, z,
yaw]; wrench: [T, tau_x, tau_y, tau_z]), the arm torque (7,) is held over
the period, and the external wrench is (force, torque), body frame.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ...models import rigid_body as rb
from ...models.chain import REVOLUTE, joint_rotation_terms
from ...models.multirotor import MultirotorState
from ...sim import flight_control as fc
from ...sim import whole_body_loop as wbl
from ...utils import graphs
from ...utils import rotations as rot
from . import build

Tensor = torch.Tensor

N_J = 7
N_R = 8
STATE_SIZE = 46
EXT_SIZE = 6
LANES = 8   # lanes per vehicle row (RP_LANES)
BLOCK = 64  # threads per block (RP_BLOCK)
MODES = {"attitude": 0, "position": 1, "wrench": 2}

_F = ctypes.c_float
_GAIN_NAMES = ("kp_x", "kp_y", "kp_z", "kd_x", "kd_y", "kd_z", "ki_x", "ki_y", "ki_z",
               "kp_roll", "kp_pitch", "kp_yaw", "kd_roll", "kd_pitch", "kd_yaw")


class RneaPlantParams(ctypes.Structure):
    """Per-configuration constants passed to rnea_plant_kernel by value --
    the C struct ``RneaPlantParams`` field for field (all 4-byte, no
    padding)."""

    _fields_ = [
        ("substeps", ctypes.c_int), ("ff_gravity", ctypes.c_int),
        *[(n, _F) for n in ("dt", "mass", "ixx", "iyy", "izz", "xlen", "ylen")],
        ("alloc", (_F * N_R) * 4),
        ("pinv", (_F * 4) * N_R),
        *[(n, _F) for n in ("a_up", "a_dn", "w_max", "c_drag", "c_roll", "ground_z")],
        ("oa", (_F * 9) * N_J), ("ob", (_F * 9) * N_J), ("oc", (_F * 9) * N_J),
        ("org", (_F * 3) * N_J), ("axis", (_F * 3) * N_J),
        ("q_lo", _F * N_J), ("q_hi", _F * N_J),
        ("link_mass", _F * N_J), ("com", (_F * 3) * N_J), ("inertia", (_F * 9) * N_J),
        ("att_kp", _F * 3), ("att_kd", _F * 3),
        *[(n, _F) for n in _GAIN_NAMES],
        ("rate_damping", _F),
    ]


@dataclass(frozen=True, eq=False)
class RneaPlantConfig:
    """A plant configuration compiled for the kernel: the by-value struct,
    the template instance it launches, and the physics its plain version
    replays."""

    substeps: int
    mode: int
    mass_matrix_per_control: bool
    struct: RneaPlantParams
    physics: Any  # sim.whole_body_loop.PlantPhysics


def _fill(dst, values) -> None:
    """Copy a nested sequence of numbers into a (nested) ctypes array."""
    for i, v in enumerate(values):
        if hasattr(dst[i], "_length_"):
            _fill(dst[i], v)
        else:
            dst[i] = float(v)


def make_rnea_plant_config(physics: "wbl.PlantPhysics", substeps: int) -> RneaPlantConfig:
    """The kernel's configuration for ``physics`` (the loop's
    :class:`~sim.whole_body_loop.PlantPhysics`, per-substep RNEA) over
    ``substeps`` substeps.  Raises ``ValueError`` for a plant the kernel
    does not take: frozen coefficients, another chain than 7 revolute
    joints, another rotor count, an unknown mode."""
    ph = physics
    vehicle, spec, inertials = ph.vehicle, ph.spec, ph.inertials
    if ph.arm_coeffs_per_control:
        raise ValueError("rnea_plant_period runs the per-substep RNEA plant; the frozen "
                         "coefficients run on plant_tick or the plain loop")
    if ph.mode not in MODES:
        raise ValueError(f"rnea_plant_period: unknown control mode {ph.mode!r}")
    if spec.n_joints != N_J or any(int(t) != REVOLUTE for t in spec.joint_type):
        raise ValueError(f"rnea_plant_period takes a chain of {N_J} revolute joints")
    alloc = vehicle.allocation_matrix()
    if alloc.shape != (4, N_R):
        raise ValueError(f"rnea_plant_period takes {N_R} rotors, got {alloc.shape[1]}")
    if inertials is None:
        raise ValueError("rnea_plant_period needs the chain's inertials")
    s = RneaPlantParams()
    s.substeps, s.dt = int(substeps), float(ph.dt)
    s.mass = float(vehicle.mass) + float(ph.extra_mass)
    s.ixx, s.iyy, s.izz = (float(v) for v in vehicle.inertia)
    s.xlen, s.ylen = float(vehicle.xlen), float(vehicle.ylen)
    _fill(s.alloc, alloc)
    _fill(s.pinv, vehicle.allocation_pinv())
    s.a_up = float(np.exp(-ph.dt / vehicle.time_constant_up))
    s.a_dn = float(np.exp(-ph.dt / vehicle.time_constant_down))
    s.w_max = float(vehicle.max_rotor_speed)
    s.c_drag = float(vehicle.rotor_drag_coefficient)
    s.c_roll = float(vehicle.rolling_moment_coefficient)
    s.ground_z = float(vehicle.ground_z)
    terms = [joint_rotation_terms(spec, j) for j in range(N_J)]
    for name, i in (("oa", 0), ("ob", 1), ("oc", 2)):
        _fill(getattr(s, name), [t[i].reshape(9) for t in terms])
    _fill(s.org, spec.origin_trans)
    _fill(s.axis, spec.axis)
    _fill(s.q_lo, spec.lower)
    _fill(s.q_hi, spec.upper)
    _fill(s.link_mass, inertials.mass)
    _fill(s.com, inertials.com)
    _fill(s.inertia, np.asarray(inertials.inertia).reshape(N_J, 9))
    mp = ph.model
    if ph.mode == "attitude":
        _fill(s.att_kp, [mp.att_kp_rp, mp.att_kp_rp, mp.att_kp_yaw])
        _fill(s.att_kd, [mp.att_kd_rp, mp.att_kd_rp, mp.att_kd_yaw])
    for name in _GAIN_NAMES:
        setattr(s, name, float(getattr(ph.gains, name)))
    if ph.mode == "wrench":
        s.ff_gravity = int(not mp.couple_arm_gravity)
        s.rate_damping = float(mp.rate_damping or 0.0)
    return RneaPlantConfig(substeps=int(substeps), mode=MODES[ph.mode],
                           mass_matrix_per_control=bool(ph.mass_matrix_per_control),
                           struct=s, physics=ph)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def pack_state(plant: "wbl.WholeBodyPlant") -> Tensor:
    """WholeBodyPlant -> the (..., STATE_SIZE) state vector."""
    b, c = plant.base, plant.ctrl
    return torch.cat([b.pos, b.quat, b.vel, b.omega, b.rotor_speed, plant.q, plant.qdot,
                      c.int_err, c.prev_err, c.m_hat, c.n_hat], dim=-1).to(torch.float32)


def unpack_state(vec: Tensor) -> "wbl.WholeBodyPlant":
    """State vector (..., STATE_SIZE) -> WholeBodyPlant (views of ``vec``)."""
    base = MultirotorState(pos=vec[..., 0:3], quat=vec[..., 3:7], vel=vec[..., 7:10],
                           omega=vec[..., 10:13], rotor_speed=vec[..., 13:21])
    ctrl = fc.FlightCtrlState(int_err=vec[..., 35:38], prev_err=vec[..., 38:41],
                              m_hat=vec[..., 41:44], n_hat=vec[..., 44:46])
    return wbl.WholeBodyPlant(base=base, q=vec[..., 21:28], qdot=vec[..., 28:35], ctrl=ctrl)


# ---------------------------------------------------------------------------
# The kernel wrapper and its plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load_library("rnea_plant_kernel")
    vp = ctypes.c_void_p
    lib.rnea_plant_launch.argtypes = [ctypes.POINTER(RneaPlantParams), ctypes.c_int,
                                      ctypes.c_int, vp, vp, vp, vp, vp, ctypes.c_int, vp]
    lib.rnea_plant_launch.restype = ctypes.c_int
    return lib


def _operand(t: Tensor, lead: tuple, width: int, device, name: str) -> Tensor:
    """``t`` as a contiguous float32 (lead + (width,)) tensor on ``device``;
    raises for another device, dtype or shape."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != lead + (width,):
        raise ValueError(
            f"rnea_plant_period: {name} must be a float32 tensor of shape {lead + (width,)} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def rnea_plant_period(rc: RneaPlantConfig, plant: "wbl.WholeBodyPlant", cmd: Tensor,
                      tau: Tensor, ext_wrench_b: Optional[tuple] = None) -> "wbl.WholeBodyPlant":
    """One control period of ``rc.substeps`` substeps for B vehicle rows in
    one launch: every field of ``plant`` with the leading shape () or (B,),
    ``cmd`` (..., 4), ``tau`` (..., 7), ``ext_wrench_b`` None or (force,
    torque), each (..., 3).  Returns the next plant (views of one new state
    vector).  Runs on a CUDA device only: anything else raises, as does an
    operand of another shape or dtype."""
    dev = plant.q.device
    if dev.type != "cuda":
        raise ValueError(f"rnea_plant_period runs on a CUDA device, got a plant on {dev}; "
                         "rnea_plant_period_plain runs anywhere")
    lead = tuple(plant.q.shape[:-1])
    if len(lead) > 1:
        raise ValueError("rnea_plant_period: expected q (7,) or (B, 7), got "
                         f"{tuple(plant.q.shape)}")
    state = _operand(pack_state(plant), lead, STATE_SIZE, dev, "state")
    cmd = _operand(cmd, lead, 4, dev, "cmd")
    tau = _operand(tau, lead, N_J, dev, "tau")
    ext = None
    if ext_wrench_b is not None:
        ext = _operand(torch.cat([ext_wrench_b[0], ext_wrench_b[1]], dim=-1), lead, EXT_SIZE,
                       dev, "ext_wrench_b")
    out = torch.empty_like(state)
    err = _lib().rnea_plant_launch(
        ctypes.byref(rc.struct), rc.mode, int(rc.mass_matrix_per_control), state.data_ptr(),
        cmd.data_ptr(), tau.data_ptr(), None if ext is None else ext.data_ptr(),
        out.data_ptr(), lead[0] if lead else 1, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rnea_plant_period launch failed with CUDA error {err}")
    graphs.count_launch(rnea_plant_period)
    return unpack_state(out)


rnea_plant_period.launches = 0


def rnea_plant_period_plain(physics: "wbl.PlantPhysics", substeps: int,
                            plant: "wbl.WholeBodyPlant", cmd: Tensor, tau: Tensor,
                            dyn=None, ext_wrench_b: Optional[tuple] = None) -> "wbl.WholeBodyPlant":
    """Plain version of :func:`rnea_plant_period`, on any device: ``substeps``
    calls of ``physics_tick``.  ``dyn`` is what ``physics_tick`` takes (the
    frozen coefficients, the period's Cholesky factor of M, or None); with
    ``mass_matrix_per_control`` and no ``dyn`` the factor is taken here, at
    the period's starting q, as the loop takes it."""
    if dyn is None and physics.mass_matrix_per_control and not physics.arm_coeffs_per_control:
        dyn = torch.linalg.cholesky_ex(rb.mass_matrix(physics.spec, physics.inertials,
                                                      plant.q)).L
    for _ in range(substeps):
        plant = wbl.physics_tick(physics, plant, cmd, tau, dyn, ext_wrench_b)
    return plant


# ---------------------------------------------------------------------------
# Inputs for checking the kernel against its plain version
# ---------------------------------------------------------------------------

def sample_rows(rc: RneaPlantConfig, n: int, seed: int = 0, device="cuda",
                external: bool = False):
    """``n`` random plant rows near hover for checking the kernel: the plant
    (every field (n, ...)) perturbed around the home posture by about what
    the reach loops see (tilt, rates, joint motion, controller state), the
    mode's base command (attitude: hover thrust and small angles; position:
    a setpoint near the base; wrench: hover thrust and small torques), arm
    torques (n, 7) and, with ``external``, an external body wrench (force,
    torque) of a few newtons.  Drawn on the CPU from ``seed``, then moved to
    ``device``."""
    from ...models import kinova

    ph = rc.physics
    g = torch.Generator().manual_seed(seed)

    def noise(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * torch.as_tensor(scale, dtype=torch.float32)

    pos = torch.tensor([0.0, 0.0, 2.1]) + noise(n, 3, scale=0.1)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0]) + noise(n, 4, scale=[0.0, 0.02, 0.02, 0.05])
    quat = quat / quat.norm(dim=-1, keepdim=True)
    lo = torch.tensor(ph.spec.lower, dtype=torch.float32) + 0.05
    hi = torch.tensor(ph.spec.upper, dtype=torch.float32) - 0.05
    q = torch.minimum(torch.maximum(torch.tensor(kinova.Q_HOME) + noise(n, 7, scale=0.1), lo), hi)
    m_total = ph.vehicle.mass + ph.extra_mass
    state = torch.cat([
        pos, quat, noise(n, 3, scale=0.1), noise(n, 3, scale=0.05),
        ph.vehicle.hover_rotor_speed(ph.extra_mass) + noise(n, 8, scale=2.0), q,
        noise(n, 7, scale=0.3), noise(n, 3, scale=0.005), noise(n, 3, scale=0.01),
        m_total + noise(n, 3, scale=0.1), noise(n, 2, scale=0.002),
    ], dim=-1)
    hover = m_total * 9.81
    if ph.mode == "position":
        cmd = torch.cat([pos + noise(n, 3, scale=0.05), noise(n, 1, scale=0.05)], dim=-1)
    elif ph.mode == "attitude":
        cmd = torch.cat([hover + noise(n, 1, scale=5.0), noise(n, 3, scale=0.03)], dim=-1)
    else:
        cmd = torch.cat([hover + noise(n, 1, scale=5.0), noise(n, 3, scale=0.5)], dim=-1)
    tau = noise(n, 7, scale=2.0)
    ext = (noise(n, 3, scale=2.0), noise(n, 3, scale=0.5)) if external else None
    dev = torch.device(device) if not isinstance(device, torch.device) else device

    def put(t):
        return t.to(torch.float32).to(dev).contiguous()

    plant = unpack_state(put(state))
    return (plant, put(cmd), put(tau), None if ext is None else tuple(put(t) for t in ext))


def hold_torque(physics: "wbl.PlantPhysics", plant: "wbl.WholeBodyPlant", qdes: Tensor,
                kp: float = 400.0, kd: float = 40.0) -> Tensor:
    """The whole-body loop's arm torque for one period at ``plant`` toward
    ``qdes``: M (kp (qdes - q) - kd qd) + nle under the base's tilt, clamped
    to the joints' effort (``control_step``'s law at its default gains), so
    that chained periods see the torques a control loop would give them."""
    spec, inertials = physics.spec, physics.inertials
    base_rot = rot.quat_to_matrix(plant.base.quat)
    m = rb.mass_matrix(spec, inertials, plant.q)
    nle = rb.nonlinear_effects(spec, inertials, plant.q, plant.qdot, base_rot=base_rot)
    tau = (m @ (kp * (qdes - plant.q) - kd * plant.qdot).unsqueeze(-1)).squeeze(-1) + nle
    effort = torch.as_tensor(spec.effort, dtype=tau.dtype, device=tau.device)
    return torch.minimum(torch.maximum(tau, -effort), effort).contiguous()
