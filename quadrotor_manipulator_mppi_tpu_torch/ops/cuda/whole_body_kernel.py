"""The whole-body MPPI solve on hand-written CUDA kernels.

Port of the JAX package's ``ops/pallas/whole_body_kernel.py``: its
single-device, sample-sharded and (through a scenario axis, its ``vmap``)
batched paths.  Per solve, three launches of ``csrc/whole_body_kernel.cu``:

* the prologue packs what the passes read from the observation into one
  54-float vector per scenario, the sigma schedule's 7-joint FK included
  (:func:`wb_prologue`, one thread per scenario; it replaces no TPU
  kernel: XLA fuses the JAX step's prologue under jit);
* pass 1 draws the noise (Philox) or reads explicit noise, rolls out base
  + arm, runs the 7-joint FK and the whole cost stack, and writes the
  per-sample cost S and the softmin partials (min, sum exp) per group of
  :data:`BLOCK` consecutive samples: :func:`wb_cost` spills the drawn noise
  to device memory as (A, H, K), :func:`wb_cost_nospill` keeps it in
  registers only.  One warp works each sample, its horizon across the
  lanes;
* pass 2 forms the softmin weights and reduces the weighted noise sum du
  and the weighted second moment per (action, step) row: :func:`wb_update`
  reads the spilled noise and :func:`wb_update_regen` draws it again, both
  with (rho, eta) combined from the pass-1 partials; the sample-sharded
  twins :func:`wb_update_shard` (reads) and :func:`wb_update_shard_regen`
  (draws again) take the global (rho, eta) that the host's collectives
  reduced over the ranks.

========================  ===========================  ===============
wrapper                   TPU kernel                   PERF.md row
========================  ===========================  ===============
wb_cost (Philox)          _cost_kernel_store           1
wb_cost (explicit eps)    _cost_kernel_noise           2
wb_update                 _update_kernel_fused_noise   3
wb_cost_nospill           _cost_kernel                 4
wb_update_regen           _update_kernel_fused         5
wb_update_shard_regen     _update_kernel               6
wb_update_shard           _update_kernel_noise         7
wb_prologue               (none: XLA's fusion)         -
========================  ===========================  ===============

Every wrapper takes one scenario (``sc`` (54,), ``u_prev`` (H, A), ...) or
a batch with a leading scenario axis (``sc`` (B, 54), ...); one launch
covers the batch.  The Philox keys are a (B,) int64 tensor on the
tensors' device, (1,) for one scenario (:func:`philox_keys`).  The solve
index ``step`` is read by the kernels from the device too: an int64 tensor,
(1,) shared by the batch or (B,) one per scenario, which a captured CUDA
graph advances in place; an int is written into a new (1,) tensor by a
fill, without a host sync (``sampling.step_tensor``).  Sphere obstacles
reach the kernel as a device buffer of any length
(a buffer the wrapper keeps per device).

Between and after the passes only (H, A)-sized work runs in plain PyTorch:
reshaping du, the collectives of the sharded solve, the Savitzky-Golay
matmul, the clamp, the warm start and the adaptive-sigma update; and,
where the sigma schedule is a callable the prologue kernel does not know,
the schedule and the scalar pack (:func:`pack_scalars`, the prologue's
plain version).

Each wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors it runs its plain version (``*_plain``), which the CPU tests use
and which the on-card checks hold the kernels against.  Each wrapper's
``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ...models import kinova
from ...models.chain import REVOLUTE, matrix_to_quat_np
from ...models.multirotor import Multirotor12State
from ...models.whole_body import WholeBodyState, _attitude_response_pair, _quat_from_rpy
from ...ops import sampling
from ...ops.sampling import key_list as _key_list, philox_keys  # noqa: F401 (re-exported)
from ...solver.mppi import (
    MPPIState, _diag_sigma, action_bounds, adapt_sigma, nominal_sequence, update_tail,
)
from ...utils import graphs, profiling
from ...utils import rotations as rot
from ...utils import savgol
from ...utils.device import device_const, resolve_device
from ...utils.pose import Pose
from . import build

Tensor = torch.Tensor

A_TOTAL = 4 + kinova.N_JOINTS  # 11
BLOCK = 16                     # samples per softmin partial = warps per wb_cost block (WB_BLOCK)
WARP_LANES = 32                # horizon steps per wb_cost chunk (WARP_LANES)
SCAN_STEPS = 5                 # shuffle steps of a warp scan (WARP_SCAN, WB_SCAN)
# wb_cost's shared-memory noise stage: A x 32 rows of BLOCK + 1 floats.
_STAGE_BYTES = A_TOTAL * WARP_LANES * (BLOCK + 1) * 4
MODES = {"attitude": 0, "position": 1, "wrench": 2}
# Shared memory per block that a kernel may opt into on the H100 (dynamic
# and static together); the launcher opts in above the default 48 KB.
SMEM_OPTIN = 227 * 1024
UPDATE_THREADS = 256           # threads per wb_update block (WB_UPDATE_THREADS)
UPDATE_ROWS = (1, 2, 4, 8)     # rows per wb_update block the source is built for
# The launcher's R by variant (regen), from timings of every R at the main
# paths' shapes on the H100 (chip_smoke.py phase 13).  Reading the noise,
# R=8 is the fastest or within noise of it, at one scenario and at 256.
# Drawing it again, R=8 loses to R=4 (103 registers against 72), and one
# scenario's 550 rows run best as 275 blocks: at least two per SM.
UPDATE_MAX_ROWS = {False: 8, True: 4}
UPDATE_MIN_BLOCKS = {False: 1, True: 2 * 132}

# Scalar-pack layout (SC_* in the CUDA source).
SC_Q0, SC_QD0, SC_POS0, SC_VEL0 = 0, 7, 14, 17
SC_TPOS, SC_TQUAT, SC_BTGT, SC_SIGMA = 20, 23, 27, 30
SC_RPY0, SC_OM0, SC_BQ0, SC_GB = 41, 44, 47, 51
SC_LEN = 54

_F = ctypes.c_float


class WbParams(ctypes.Structure):
    """Per-configuration constants passed to wb_cost by value — the C
    struct ``WbParams`` field for field (all 4-byte, no padding)."""

    _fields_ = [
        *[(n, ctypes.c_int) for n in
          ("mode", "h", "k", "rotor_lag", "couple", "jl_soft", "n_obs", "pad_")],
        *[(n, _F) for n in
          ("dt", "inv_lam", "mass", "lag_alpha", "drag_alpha", "rate_alpha")],
        ("inertia", _F * 3),
        ("ax_a", (_F * 4) * 3),
        ("ax_b", (_F * 2) * 3),
        ("ax_kp", _F * 3),
        ("ax_kd", _F * 3),
        ("q_lo", _F * 7),
        ("q_hi", _F * 7),
        ("oq", (_F * 4) * 7),
        ("ot", (_F * 3) * 7),
        ("com", (_F * 3) * 7),
        ("link_mass", _F * 7),
        *[(n, _F) for n in
          ("w_pos_stage", "w_pos_term", "w_ori_stage", "w_ori_term",
           "w_base", "w_att", "w_omega", "w_vel", "w_action", "w_jl", "gamma",
           "w_obs", "w_stop", "stop_horizon")],
        ("ax_pow", ((_F * 4) * SCAN_STEPS) * 3),
        *[(n, _F * SCAN_STEPS) for n in ("lag_pow", "drag_pow", "rate_pow")],
    ]


@dataclass(frozen=True, eq=False)
class WbKernelConfig:
    """A configuration compiled for the kernels: sizes plus the by-value
    parameter struct and the sphere obstacles, (n_obs, 4) rows (x, y, z,
    radius) on the host.  Built once per solver (:func:`make_kernel_config`)."""

    params: Any            # solver.whole_body.WholeBodyMPPIParams
    n_samples: int
    n_horizon: int
    n_blocks: int
    inv_lam: float
    struct: WbParams
    obstacles: np.ndarray


def _fill(arr, values) -> None:
    for i, v in enumerate(values):
        arr[i] = float(v)


def cost_smem_bytes(h: int, variant: int) -> int:
    """Shared memory of one wb_cost block at horizon ``h``: the scalars and
    the warm start, the noise stage (spill and explicit noise: ``variant``
    1 and 0), and the static share (one cost per warp)."""
    stage = _STAGE_BYTES if variant != 2 else 0
    return (SC_LEN + h * A_TOTAL) * 4 + stage + BLOCK * 4


def max_horizon() -> int:
    """The longest horizon at which every wb_cost variant fits
    :data:`SMEM_OPTIN` (each step adds A floats)."""
    return (SMEM_OPTIN - max(cost_smem_bytes(0, v) for v in range(3))) // (4 * A_TOTAL)


def scan_powers(m) -> list:
    """m^(2^i) for i < SCAN_STEPS, by repeated squaring in float64: the step
    maps of wb_cost's warp scans (a scalar or a square matrix)."""
    out = [np.asarray(m, dtype=np.float64)]
    for _ in range(SCAN_STEPS - 1):
        out.append(out[-1] @ out[-1] if out[-1].ndim else out[-1] * out[-1])
    return out


class KernelRefusal(ValueError):
    """A whole-body configuration the kernels cannot run but the plain
    pipeline can (``make_whole_body_solver(..., backend="torch")``)."""


def make_kernel_config(params, n_local_samples: Optional[int] = None) -> WbKernelConfig:
    """Validate ``params`` for the kernels (the JAX kernel's checks, same
    messages) and build the constant struct.  ``n_local_samples``: this
    rank's share of the samples in a sample-sharded solve (default: all
    ``n_samples``)."""
    cfg, mp, cp = params.mppi, params.model, params.cost
    h, k, dt = cfg.n_horizon, n_local_samples or cfg.n_samples, cfg.dt
    if cfg.n_action != A_TOTAL:
        raise ValueError(f"whole-body kernel expects {A_TOTAL} actions")
    if k % BLOCK:
        raise KernelRefusal(f"local sample count must be a multiple of {BLOCK}")
    if mp.control_mode not in MODES:
        raise ValueError("unknown control mode for the fused kernel")
    if cp.ori_mode != "log":
        raise KernelRefusal("fused kernel implements the 'log' orientation metric")
    if cfg.zero_mean_noise:
        raise KernelRefusal("zero_mean_noise unsupported in the fused kernel")
    if cfg.adaptive_sigma and cfg.sigma_scale_fn is not None:
        raise ValueError("adaptive_sigma and sigma_scale_fn are exclusive")
    if np.ndim(cfg.sigma) == 2:
        raise KernelRefusal("fused kernel requires scalar or diagonal sigma")
    if mp.control_mode in ("attitude", "wrench") and not mp.time_parallel:
        raise KernelRefusal("fused kernel is parallel-in-time only")
    if mp.arm_tip != "link_7":
        raise KernelRefusal("fused kernel bakes the link_7 tip frame")
    spec = mp.chain()
    if (not np.allclose(spec.tip_rot, np.eye(3)) or not np.allclose(spec.tip_trans, 0.0)
            or np.any(spec.joint_type != REVOLUTE)
            or not np.allclose(spec.axis, [0.0, 0.0, 1.0])):
        raise KernelRefusal("fused kernel expects revolute +z joints and an identity tip")
    if h > max_horizon():
        raise KernelRefusal("horizon too long for the kernel's shared-memory warm start")

    s = WbParams()
    s.mode, s.h, s.k = MODES[mp.control_mode], h, k
    s.rotor_lag = int(mp.rotor_lag_tau > 0.0)
    s.couple = int(bool(mp.couple_arm_gravity))
    s.jl_soft = int(bool(cp.joint_limit_soft))
    s.dt, s.inv_lam = dt, 1.0 / float(cfg.lam)
    s.mass = mp.vehicle.mass + mp.arm_mass_lump
    s.lag_alpha = float(np.exp(-dt / mp.rotor_lag_tau)) if mp.rotor_lag_tau > 0.0 else 0.0
    s.drag_alpha = 1.0 - dt * mp.drag_kd
    s.rate_alpha = 1.0 - dt * mp.rate_damping
    _fill(s.inertia, mp.vehicle.inertia)
    if mp.control_mode == "attitude":
        gains = [(mp.att_kp_rp, mp.att_kd_rp)] * 2 + [(mp.att_kp_yaw, mp.att_kd_yaw)]
    elif mp.control_mode == "position":
        gains = [(mp.pos_kp_xy, mp.pos_kd_xy)] * 2 + [(mp.pos_kp_z, mp.pos_kd_z)]
    else:
        gains = []
    for i, (kp, kd) in enumerate(gains):
        a, b = _attitude_response_pair(dt, kp, kd)
        _fill(s.ax_a[i], a.ravel())
        _fill(s.ax_b[i], b)
        s.ax_kp[i], s.ax_kd[i] = kp, kd
        for j, m in enumerate(scan_powers(np.reshape(s.ax_a[i], (2, 2)))):
            _fill(s.ax_pow[i][j], m.ravel())
    for name, c in (("lag_pow", s.lag_alpha), ("drag_pow", s.drag_alpha),
                    ("rate_pow", s.rate_alpha)):
        _fill(getattr(s, name), scan_powers(c))
    _fill(s.q_lo, spec.lower)
    _fill(s.q_hi, spec.upper)
    inertials = mp.inertials()
    for j in range(kinova.N_JOINTS):
        _fill(s.oq[j], matrix_to_quat_np(spec.origin_rot[j]))
        _fill(s.ot[j], spec.origin_trans[j])
        _fill(s.com[j], inertials.com[j])
    _fill(s.link_mass, inertials.mass)
    s.w_pos_stage, s.w_pos_term = cp.stage_pose_weight, cp.terminal_pose_weight
    s.w_ori_stage, s.w_ori_term = cp.stage_orientation_weight, cp.terminal_orientation_weight
    s.w_base, s.w_att, s.w_omega = cp.base_pos_weight, cp.attitude_weight, cp.omega_weight
    s.w_vel, s.w_action, s.w_jl = cp.vel_weight, cp.action_weight, cp.joint_limit_weight
    s.gamma = cp.gamma
    s.w_obs, s.w_stop, s.stop_horizon = cp.obstacle_weight, cp.stop_weight, cp.stop_horizon
    s.n_obs = len(cp.obstacle_centers) if cp.obstacle_weight else 0
    obstacles = np.asarray([(*c, r) for c, r in zip(cp.obstacle_centers, cp.obstacle_radii)],
                           np.float64).reshape(-1, 4)[:s.n_obs]
    return WbKernelConfig(params=params, n_samples=k, n_horizon=h,
                          n_blocks=k // BLOCK, inv_lam=s.inv_lam, struct=s,
                          obstacles=obstacles)


def _obstacle_buffer(kc: WbKernelConfig, like: Tensor) -> Optional[Tensor]:
    """The sphere rows (n_obs, 4) as float32 on ``like``'s device (copied
    there once, :func:`device_const`), or None without obstacles."""
    return device_const(kc.obstacles, like) if len(kc.obstacles) else None


# ---------------------------------------------------------------------------
# Observation <-> scalar pack
# ---------------------------------------------------------------------------

def pack_scalars(obs, sigma_live: Tensor) -> Tensor:
    """The kernels' per-solve inputs from the observation (54 floats per
    scenario): q0, qd0, pos0, vel0, EE target pose, base target, live
    sigma, rpy0, omega0, and the initial attitude quaternion and base-frame
    gravity.  With a leading scenario axis on the observation's fields the
    result is (B, 54); ``sigma_live`` (A,) or (B, A) broadcasts."""
    st = obs.state
    rpy = st.base.rpy.to(torch.float32)
    lead = tuple(rpy.shape[:-1])
    bq0 = _quat_from_rpy(rpy)
    g_b = -9.81 * rot.quat_to_matrix(bq0)[..., 2, :]
    parts = (st.q, st.qdot, st.base.pos, st.base.vel, obs.ee_target.position,
             obs.ee_target.quat, obs.base_target, sigma_live, rpy, st.base.omega,
             bq0, g_b)
    return torch.cat([torch.broadcast_to(p.to(torch.float32), lead + p.shape[-1:])
                      for p in parts], dim=-1)


class WbSchedule(ctypes.Structure):
    """The sigma schedule as :func:`wb_prologue` runs it — the C struct
    ``WbSchedule`` field for field (all 4-byte, no padding)."""

    _fields_ = [
        ("kind", ctypes.c_int), ("base_floor_set", ctypes.c_int),
        *[(n, _F) for n in ("inv_r0", "floor", "base_floor")],
        ("oq", (_F * 4) * kinova.N_JOINTS),
        ("ot", (_F * 3) * kinova.N_JOINTS),
    ]


# The observation fields wb_prologue reads (PRO_* in the CUDA source): name,
# width, and how to get it from (observation, live sigma).
PROLOGUE_FIELDS = (
    ("q", kinova.N_JOINTS, lambda o, s: o.state.q),
    ("qdot", kinova.N_JOINTS, lambda o, s: o.state.qdot),
    ("pos", 3, lambda o, s: o.state.base.pos),
    ("vel", 3, lambda o, s: o.state.base.vel),
    ("ee_pos", 3, lambda o, s: o.ee_target.position),
    ("ee_quat", 4, lambda o, s: o.ee_target.quat),
    ("base_target", 3, lambda o, s: o.base_target),
    ("sigma", A_TOTAL, lambda o, s: s),
    ("rpy", 3, lambda o, s: o.state.base.rpy),
    ("omega", 3, lambda o, s: o.state.base.omega),
)


class WbPrologueArgs(ctypes.Structure):
    """The C struct ``WbPrologueArgs``: each field's rows and the floats
    between two scenarios' rows (0: one row shared by every scenario)."""

    _fields_ = [("field", ctypes.c_void_p * len(PROLOGUE_FIELDS)),
                ("stride", ctypes.c_longlong * len(PROLOGUE_FIELDS))]


@dataclass(frozen=True, eq=False)
class WbPrologueConfig:
    """A configuration's sigma schedule compiled for :func:`wb_prologue`:
    ``scale_fn`` (``MPPIConfig.sigma_scale_fn``, which the plain version
    calls) and the by-value struct."""

    scale_fn: Any
    struct: WbSchedule


def make_prologue_config(cfg) -> Optional[WbPrologueConfig]:
    """The prologue kernel's view of ``cfg`` (an ``MPPIConfig``), or None
    where its ``sigma_scale_fn`` is a callable the kernel does not know:
    the kernel runs no schedule (None) and the end-effector error schedule
    (``solver/whole_body.ee_error_sigma_schedule``, known by its
    ``__qmm_schedule__`` kind ``"ee_error"``), whose FK is of the chain the
    schedule uses."""
    from ...solver.whole_body import _SCHEDULE_CHAIN

    fn = cfg.sigma_scale_fn
    spec = getattr(fn, "__qmm_schedule__", None)
    s = WbSchedule()
    if fn is not None:
        if spec is None or spec.get("kind") != "ee_error":
            return None
        s.kind = 1
        # A CUDA tensor divided by a number is multiplied by its float32 reciprocal.
        s.inv_r0 = float(np.float32(1.0) / np.float32(spec["r0"]))
        s.floor = spec["floor"]
        if spec.get("base_floor") is not None:
            s.base_floor_set, s.base_floor = 1, spec["base_floor"]
        for j in range(kinova.N_JOINTS):  # revolute +z joints, identity tip (a test holds it)
            _fill(s.oq[j], matrix_to_quat_np(_SCHEDULE_CHAIN.origin_rot[j]))
            _fill(s.ot[j], _SCHEDULE_CHAIN.origin_trans[j])
    return WbPrologueConfig(scale_fn=fn, struct=s)


def obs_from_scalars(sc: Tensor):
    """Inverse of :func:`pack_scalars` (the observation part)."""
    from ...solver.whole_body import WholeBodyObs

    def part(i, n):
        return sc[..., i:i + n]

    base = Multirotor12State(pos=part(SC_POS0, 3), rpy=part(SC_RPY0, 3),
                             vel=part(SC_VEL0, 3), omega=part(SC_OM0, 3))
    return WholeBodyObs(
        state=WholeBodyState(base=base, q=part(SC_Q0, 7), qdot=part(SC_QD0, 7)),
        ee_target=Pose(position=part(SC_TPOS, 3), quat=part(SC_TQUAT, 4)),
        base_target=part(SC_BTGT, 3),
    )


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load_library("whole_body_kernel")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wb_cost_launch.argtypes = [ctypes.POINTER(WbParams), vp, vp, vp, vp, vp, vp, vp,
                                   vp, ci, ci, ci, ci, vp, vp]
    lib.wb_cost_launch.restype = ci
    lib.wb_update_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                     ci, ci, ci, ctypes.c_float, ci, ci, vp, vp, vp]
    lib.wb_update_launch.restype = ci
    lib.wb_prologue_launch.argtypes = [ctypes.POINTER(WbSchedule),
                                       ctypes.POINTER(WbPrologueArgs), vp, ci, vp]
    lib.wb_prologue_launch.restype = ci
    return lib


def _check(t: Tensor, shape, device, name: str, dtype=torch.float32) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {str(dtype)[6:]} tensor of shape {tuple(shape)} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _key_ptr(seeds: Tensor, lead, device):
    _check(seeds, lead or (1,), device, "seeds", torch.int64)
    return seeds.data_ptr()


def _step_arg(step, lead, device) -> Tuple[Tensor, int]:
    """(the solve index as an int64 device tensor, its stride over the
    scenarios): (1,) shared (stride 0) or one per scenario (stride 1)."""
    t = sampling.step_tensor(step, device)
    _check(t, (1,) if t.numel() == 1 else (lead or (1,)), device, "step", torch.int64)
    return t, int(t.numel() != 1)


def _n_scen(lead) -> int:
    return lead[0] if lead else 1


def _launch_cost(kc: WbKernelConfig, name: str, sc: Tensor, u_prev: Tensor,
                 eps: Optional[Tensor], seeds: Optional[Tensor], step, k_off: int,
                 variant: int):
    """One wb_cost launch of ``variant`` (0: read ``eps``; 1: draw and
    spill; 2: draw, no spill)."""
    k, h, dev = kc.n_samples, kc.n_horizon, sc.device
    lead = tuple(sc.shape[:-1])
    _check(sc, lead + (SC_LEN,), dev, "sc")
    _check(u_prev, lead + (h, A_TOTAL), dev, "u_prev")
    if variant == 1:
        eps = torch.empty(lead + (A_TOTAL, h, k), dtype=torch.float32, device=dev)
    if eps is not None:
        _check(eps, lead + (A_TOTAL, h, k), dev, "eps")
    s = torch.empty(lead + (k,), dtype=torch.float32, device=dev)
    m_part = torch.empty(lead + (kc.n_blocks,), dtype=torch.float32, device=dev)
    e_part = torch.empty(lead + (kc.n_blocks,), dtype=torch.float32, device=dev)
    keys = _key_ptr(seeds, lead, dev) if variant else None
    steps, stride = _step_arg(step, lead, dev) if variant else (None, 0)
    rc = _lib().wb_cost_launch(
        ctypes.byref(kc.struct), sc.data_ptr(), u_prev.data_ptr(), _ptr(eps), s.data_ptr(),
        m_part.data_ptr(), e_part.data_ptr(), keys, _ptr(steps), stride, int(k_off), variant,
        _n_scen(lead), _ptr(_obstacle_buffer(kc, sc)), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, name)
    return s, m_part, e_part, eps


def update_blocks(rows: int, rows_per_block: int) -> int:
    """Blocks per scenario of a wb_update launch: ceil(rows / R)."""
    return -(-rows // rows_per_block)


def update_rows_per_block(regen: bool, n_scen: int, rows: int) -> int:
    """R, the (action, step) rows of one wb_update block: the most of
    :data:`UPDATE_ROWS`, up to :data:`UPDATE_MAX_ROWS`, that still gives the
    launch :data:`UPDATE_MIN_BLOCKS` blocks, else 1."""
    need, most = UPDATE_MIN_BLOCKS[regen], UPDATE_MAX_ROWS[regen]
    return max([r for r in UPDATE_ROWS
                if r <= most and n_scen * update_blocks(rows, r) >= need], default=1)


def _launch_update(kc: WbKernelConfig, name: str, s: Tensor, eps: Optional[Tensor] = None,
                   m_part: Optional[Tensor] = None, e_part: Optional[Tensor] = None,
                   se: Optional[Tensor] = None, sc: Optional[Tensor] = None,
                   seeds: Optional[Tensor] = None, step=0, k_off: int = 0,
                   rows_per_block: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """One wb_update launch; ``rows_per_block`` overrides
    :func:`update_rows_per_block` (for timing each R)."""
    k, h, dev = kc.n_samples, kc.n_horizon, s.device
    lead = tuple(s.shape[:-1])
    rows = A_TOTAL * h
    _check(s, lead + (k,), dev, "s")
    if eps is not None:
        _check(eps, lead + (A_TOTAL, h, k), dev, "eps")
    else:
        _check(sc, lead + (SC_LEN,), dev, "sc")
    if se is not None:
        _check(se, lead + (2,), dev, "se")
    else:
        _check(m_part, lead + (kc.n_blocks,), dev, "m_part")
        _check(e_part, lead + (kc.n_blocks,), dev, "e_part")
    if s.data_ptr() % 16 or (eps is not None and eps.data_ptr() % 16):
        raise ValueError("s, eps: wb_update reads 16-byte vectors; pass 16-byte aligned tensors")
    regen = eps is None
    keys = _key_ptr(seeds, lead, dev) if regen else None
    steps, stride = _step_arg(step, lead, dev) if regen else (None, 0)
    n_scen = _n_scen(lead)
    r = rows_per_block or update_rows_per_block(regen, n_scen, rows)
    if r not in UPDATE_ROWS:
        raise ValueError(f"rows_per_block must be one of {UPDATE_ROWS}, got {r}")
    du = torch.empty(lead + (rows,), dtype=torch.float32, device=dev)
    m2 = torch.empty(lead + (rows,), dtype=torch.float32, device=dev)
    rc = _lib().wb_update_launch(
        _ptr(eps), s.data_ptr(), _ptr(m_part), _ptr(e_part), _ptr(se), _ptr(sc), keys,
        _ptr(steps), stride, int(k_off), kc.n_blocks, k, h, n_scen, kc.inv_lam, int(regen), r,
        du.data_ptr(), m2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, name)
    return du, m2


def wb_cost(kc: WbKernelConfig, sc: Tensor, u_prev: Tensor, eps: Optional[Tensor] = None,
            seeds: Optional[Tensor] = None, step=0,
            k_off: int = 0) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Pass 1 (rows 1 and 2).  Returns (S (K,), group minima (n_blocks,),
    group sums of exp((m - S)/lambda) (n_blocks,), eps (A, H, K)), each
    with the batch's leading axis.  With ``eps=None`` the noise is the
    Philox stream of (seeds, step) at global samples k_off + k, scaled by
    the packed sigma, and is returned; otherwise ``eps`` is read."""
    if sc.device.type == "cpu":
        return wb_cost_plain(kc, sc, u_prev, eps, seeds, step, k_off)
    out = _launch_cost(kc, "wb_cost", sc, u_prev, eps, seeds, step, k_off,
                       1 if eps is None else 0)
    graphs.count_launch(wb_cost)
    return out


wb_cost.launches = 0


def wb_cost_nospill(kc: WbKernelConfig, sc: Tensor, u_prev: Tensor, seeds: Tensor,
                    step=0, k_off: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """Pass 1 without the noise spill (row 4): :func:`wb_cost`'s Philox
    variant, returning (S, group minima, group sums) and writing no noise;
    pass 2 draws it again (:func:`wb_update_regen`,
    :func:`wb_update_shard_regen`)."""
    if sc.device.type == "cpu":
        return wb_cost_nospill_plain(kc, sc, u_prev, seeds, step, k_off)
    s, m_part, e_part, _ = _launch_cost(kc, "wb_cost_nospill", sc, u_prev, None, seeds, step,
                                        k_off, 2)
    graphs.count_launch(wb_cost_nospill)
    return s, m_part, e_part


wb_cost_nospill.launches = 0


def wb_update(kc: WbKernelConfig, eps: Tensor, s: Tensor, m_part: Tensor,
              e_part: Tensor) -> Tuple[Tensor, Tensor]:
    """Pass 2 (row 3).  Softmin weights w = exp((rho - S)/lambda)/eta from
    the group partials; returns (du, m2), each (A*H,) over the rows (a, t)
    of eps: du = sum_k w_k eps_k and m2 = sum_k w_k eps_k^2."""
    if eps.device.type == "cpu":
        return wb_update_plain(kc, eps, s, m_part, e_part)
    out = _launch_update(kc, "wb_update", s, eps=eps, m_part=m_part, e_part=e_part)
    graphs.count_launch(wb_update)
    return out


wb_update.launches = 0


def wb_update_regen(kc: WbKernelConfig, sc: Tensor, s: Tensor, m_part: Tensor,
                    e_part: Tensor, seeds: Tensor, step=0,
                    k_off: int = 0) -> Tuple[Tensor, Tensor]:
    """Pass 2 after :func:`wb_cost_nospill` (row 5): :func:`wb_update` on
    the noise drawn again from (seeds, step, k_off) and the packed sigma."""
    if s.device.type == "cpu":
        return wb_update_regen_plain(kc, sc, s, m_part, e_part, seeds, step, k_off)
    out = _launch_update(kc, "wb_update_regen", s, m_part=m_part, e_part=e_part, sc=sc,
                         seeds=seeds, step=step, k_off=k_off)
    graphs.count_launch(wb_update_regen)
    return out


wb_update_regen.launches = 0


def wb_update_shard(kc: WbKernelConfig, eps: Tensor, s: Tensor,
                    se: Tensor) -> Tuple[Tensor, Tensor]:
    """Sharded pass 2 on the spilled noise (row 7): this rank's (du, m2)
    rows with the global ``se`` = (rho, eta) (2,) per scenario, for the
    host to all-reduce."""
    if s.device.type == "cpu":
        return wb_update_shard_plain(kc, eps, s, se)
    out = _launch_update(kc, "wb_update_shard", s, eps=eps, se=se)
    graphs.count_launch(wb_update_shard)
    return out


wb_update_shard.launches = 0


def wb_update_shard_regen(kc: WbKernelConfig, sc: Tensor, s: Tensor, se: Tensor,
                          seeds: Tensor, step=0,
                          k_off: int = 0) -> Tuple[Tensor, Tensor]:
    """Sharded pass 2 after :func:`wb_cost_nospill` (row 6):
    :func:`wb_update_shard` on the noise drawn again."""
    if s.device.type == "cpu":
        return wb_update_shard_regen_plain(kc, sc, s, se, seeds, step, k_off)
    out = _launch_update(kc, "wb_update_shard_regen", s, se=se, sc=sc, seeds=seeds, step=step,
                         k_off=k_off)
    graphs.count_launch(wb_update_shard_regen)
    return out


wb_update_shard_regen.launches = 0


def _prologue_field(t: Tensor, width: int, lead, device, name: str) -> Tuple[Tensor, int]:
    """``t`` as float32 rows of ``width`` on ``device`` and its stride over
    the scenarios: one row for all (stride 0) or one per scenario."""
    t = t.to(torch.float32)
    if t.stride(-1) != 1:
        t = t.contiguous()
    if t.device != device or t.shape[-1] != width or t.ndim > len(lead) + 1 \
            or (t.ndim > 1 and t.shape[0] not in (1, _n_scen(lead))):
        raise ValueError(f"wb_prologue: {name} must be ({width},) or {lead + (width,)} on "
                         f"{device}, got {tuple(t.shape)} on {t.device}")
    return t, (t.stride(0) if t.ndim > 1 and t.shape[0] > 1 else 0)


def wb_prologue(pc: WbPrologueConfig, obs, sigma_live: Tensor) -> Tensor:
    """The solve's scalar pack (54 floats per scenario) from the
    observation and the live sigma, scaled by the configuration's sigma
    schedule: :func:`pack_scalars` of ``sigma_live * scale_fn(obs)`` (of
    ``sigma_live`` without a schedule) in one launch, one thread per
    scenario.  The scenarios are the observation's rpy's leading axis (none
    or B); each other field, ``sigma_live`` (A,) or (B, A) included, has
    the same or none.  The fields are read as float32 (the plain version
    runs the schedule in the observation's own dtype)."""
    if sigma_live.device.type == "cpu":
        return wb_prologue_plain(pc, obs, sigma_live)
    dev = sigma_live.device
    lead = tuple(obs.state.base.rpy.shape[:-1])
    if len(lead) > 1:
        raise ValueError(f"wb_prologue takes one scenario axis, got {lead}")
    args, keep = WbPrologueArgs(), []  # keep: any float32 copies, alive until the launch
    for i, (name, width, get) in enumerate(PROLOGUE_FIELDS):
        t, args.stride[i] = _prologue_field(get(obs, sigma_live), width, lead, dev, name)
        args.field[i] = t.data_ptr()
        keep.append(t)
    sc = torch.empty(lead + (SC_LEN,), dtype=torch.float32, device=dev)
    rc = _lib().wb_prologue_launch(ctypes.byref(pc.struct), ctypes.byref(args), sc.data_ptr(),
                                   _n_scen(lead), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "wb_prologue")
    graphs.count_launch(wb_prologue)
    return sc


wb_prologue.launches = 0


def wb_prologue_plain(pc: WbPrologueConfig, obs, sigma_live: Tensor) -> Tensor:
    """Plain version of :func:`wb_prologue`: the configuration's schedule,
    then :func:`pack_scalars`."""
    if pc.scale_fn is not None:
        sigma_live = sigma_live * pc.scale_fn(obs)
    return pack_scalars(obs, sigma_live)


KERNEL_WRAPPERS = (wb_prologue, wb_cost, wb_cost_nospill, wb_update, wb_update_regen,
                   wb_update_shard, wb_update_shard_regen)


def philox_eps(kc: WbKernelConfig, sc: Tensor, seeds: Tensor, step=0,
               k_off: int = 0) -> Tensor:
    """The noise (A, H, K) the kernels draw: Philox normals at global
    samples k_off + k scaled by the packed sigma; per scenario for a
    batch.  ``step`` as the kernels take it: an int, or an int64 device
    tensor, (1,) or one per scenario."""
    scs = sc.reshape(-1, SC_LEN)
    z = sampling.philox_normals(seeds.reshape(-1), step, kc.n_samples, kc.n_horizon, A_TOTAL,
                                sc.device, sample_offset=k_off)
    eps = z * scs[:, SC_SIGMA:SC_SIGMA + A_TOTAL].view(-1, A_TOTAL, 1, 1)
    return eps.view(sc.shape[:-1] + eps.shape[1:])


def wb_cost_plain(kc: WbKernelConfig, sc: Tensor, u_prev: Tensor,
                  eps: Optional[Tensor] = None, seeds: Optional[Tensor] = None,
                  step=0, k_off: int = 0) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of :func:`wb_cost`: the operator-form rollout and cost
    stack of ``solver/whole_body`` on v = u_prev + eps, then the softmin
    partials per group of :data:`BLOCK` samples; one scenario at a time."""
    from ...solver.whole_body import rollout_cost_fns

    if eps is None:
        eps = philox_eps(kc, sc, seeds, step, k_off)
    if sc.ndim == 2:
        outs = [wb_cost_plain(kc, sc[b], u_prev[b], eps[b]) for b in range(sc.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    v = u_prev[None] + eps.permute(2, 1, 0)
    obs = obs_from_scalars(sc)
    rollout_fn, cost_fn = rollout_cost_fns(kc.params)
    s = cost_fn(rollout_fn(v, obs), v, u_prev, obs)
    blk = s.view(kc.n_blocks, BLOCK)
    m = blk.min(dim=1).values
    e = torch.exp((m[:, None] - blk) * kc.inv_lam).sum(dim=1)
    return s, m, e, eps


def wb_cost_nospill_plain(kc: WbKernelConfig, sc: Tensor, u_prev: Tensor, seeds: Tensor,
                          step=0, k_off: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`wb_cost_nospill`."""
    return wb_cost_plain(kc, sc, u_prev, None, seeds, step, k_off)[:3]


def softmin_normalizers(kc: WbKernelConfig, m_part: Tensor, e_part: Tensor,
                        group=None) -> Tensor:
    """(rho, eta) (2,) per scenario from the group partials:
    rho = min_i m_i, eta = sum_i e_i exp((rho - m_i)/lambda).  With a
    ``torch.distributed`` sample ``group``, over every rank's partials in
    the JAX order: all-reduce MIN of rho, then SUM of eta (which needs the
    global rho)."""
    rho = m_part.min(dim=-1, keepdim=True).values
    if group is not None:
        dist.all_reduce(rho, op=dist.ReduceOp.MIN, group=group)
    eta = torch.sum(e_part * torch.exp((rho - m_part) * kc.inv_lam), dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(eta, op=dist.ReduceOp.SUM, group=group)
    return torch.cat([rho, eta], dim=-1)


def _weighted_rows(kc: WbKernelConfig, eps: Tensor, s: Tensor,
                   se: Tensor) -> Tuple[Tensor, Tensor]:
    w = torch.exp((se[..., :1] - s) * kc.inv_lam) / se[..., 1:]
    flat = eps.reshape(eps.shape[:-3] + (A_TOTAL * kc.n_horizon, kc.n_samples))
    return (flat @ w[..., None])[..., 0], ((flat * flat) @ w[..., None])[..., 0]


def wb_update_plain(kc: WbKernelConfig, eps: Tensor, s: Tensor, m_part: Tensor,
                    e_part: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`wb_update`: the softmin from the partials,
    the weighted sum and the weighted second moment."""
    return _weighted_rows(kc, eps, s, softmin_normalizers(kc, m_part, e_part))


def wb_update_regen_plain(kc: WbKernelConfig, sc: Tensor, s: Tensor, m_part: Tensor,
                          e_part: Tensor, seeds: Tensor, step=0,
                          k_off: int = 0) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`wb_update_regen`."""
    return wb_update_plain(kc, philox_eps(kc, sc, seeds, step, k_off), s, m_part, e_part)


def wb_update_shard_plain(kc: WbKernelConfig, eps: Tensor, s: Tensor,
                          se: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`wb_update_shard`."""
    return _weighted_rows(kc, eps, s, se)


def wb_update_shard_regen_plain(kc: WbKernelConfig, sc: Tensor, s: Tensor, se: Tensor,
                                seeds: Tensor, step=0,
                                k_off: int = 0) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`wb_update_shard_regen`."""
    return _weighted_rows(kc, philox_eps(kc, sc, seeds, step, k_off), s, se)


# ---------------------------------------------------------------------------
# The solve step
# ---------------------------------------------------------------------------

def make_whole_body_cuda_step(params, device="cuda", group=None,
                              n_local_samples: Optional[int] = None, noise_spill: bool = True,
                              n_scenarios: Optional[int] = None):
    """Build ``step(state, obs, z=None) -> (u_seq, new_state)`` on the
    kernels.

    ``z``: optional standard normals (K, H, A), the layout of
    ``sampling.sample_noise``, used instead of the Philox stream (pass 1
    then reads them, row 2).  On the Philox stream one rank runs rows 1 + 3
    (``noise_spill``) or rows 4 + 5.

    ``group`` and ``n_local_samples`` (the JAX builder's ``axis_name`` and
    ``n_local_samples``): this rank solves its ``n_local_samples`` of the
    samples of a ``torch.distributed`` sample group, at global sample
    offset (group rank) * n_local_samples; pass 2 is rows 7 or 6, between
    the passes the group all-reduces rho (MIN) and eta (SUM), then du (SUM,
    before smoothing) and, with adaptive sigma, m2 (SUM).  ``z`` is then
    this rank's (n_local_samples, H, A) block.

    ``n_scenarios``: B independent problems per call, each pass one launch
    (the JAX step's ``vmap``): ``state.u_prev`` (B, H, A), ``state.sigma``
    (B, A), ``state.seed`` a (B,) int64 tensor of keys on the card, the
    observation's fields and ``u_seq`` with a leading B, ``z`` (B, K, H, A).

    The scalar pack, with the sigma schedule's FK, is one launch of
    :func:`wb_prologue` where the configuration has no schedule or the
    end-effector error schedule; any other ``sigma_scale_fn`` is called
    and its scale packed in plain PyTorch (:func:`make_prologue_config`)."""
    dev = resolve_device(device)
    kc = make_kernel_config(params, n_local_samples)
    cfg = params.mppi
    pc = make_prologue_config(cfg)
    h = cfg.n_horizon
    lead = () if n_scenarios is None else (int(n_scenarios),)
    k_off = 0 if group is None else dist.get_rank(group) * kc.n_samples
    sigma_base = _diag_sigma(cfg, torch.float32, dev)
    smoother = None
    if cfg.savgol_window:
        smoother = torch.as_tensor(
            savgol.savgol_matrix(h, cfg.savgol_window, cfg.savgol_polyorder),
            dtype=torch.float32,
        ).to(dev)
    lo, hi = action_bounds(cfg, torch.float32, dev)
    nominal = nominal_sequence(cfg, torch.float32, dev)

    def step(state: MPPIState, obs, z=None) -> Tuple[Tensor, MPPIState]:
        sigma_live = state.sigma if cfg.adaptive_sigma else sigma_base
        if pc is not None:
            sc = wb_prologue(pc, obs, sigma_live)
        else:
            sigma_live = sigma_live * cfg.sigma_scale_fn(obs)
            sc = pack_scalars(obs, sigma_live)
        u_prev = state.u_prev.to(torch.float32).contiguous()
        seeds, n = philox_keys(state.seed, dev), sampling.step_tensor(state.step, dev)
        eps = None
        if z is not None:
            z = torch.as_tensor(z, dtype=torch.float32, device=dev)
            sigma = sc[..., None, None, SC_SIGMA:SC_SIGMA + A_TOTAL]
            eps = (z * sigma).transpose(-1, -3).contiguous()
        profiling.mark("solve.cost")
        if eps is not None:
            s, m_part, e_part, eps = wb_cost(kc, sc, u_prev, eps)
        elif noise_spill:
            s, m_part, e_part, eps = wb_cost(kc, sc, u_prev, None, seeds, n, k_off)
        else:
            s, m_part, e_part = wb_cost_nospill(kc, sc, u_prev, seeds, n, k_off)
        profiling.mark("solve.update")
        if group is None:
            if eps is not None:
                du_rows, m2_rows = wb_update(kc, eps, s, m_part, e_part)
            else:
                du_rows, m2_rows = wb_update_regen(kc, sc, s, m_part, e_part, seeds, n)
        else:
            se = softmin_normalizers(kc, m_part, e_part, group)
            if eps is not None:
                du_rows, m2_rows = wb_update_shard(kc, eps, s, se)
            else:
                du_rows, m2_rows = wb_update_shard_regen(kc, sc, s, se, seeds, n, k_off)
        profiling.mark("solve.tail")
        if group is not None:
            dist.all_reduce(du_rows, op=dist.ReduceOp.SUM, group=group)
        du = du_rows.view(lead + (A_TOTAL, h)).transpose(-1, -2)
        u, warm = update_tail(cfg, u_prev, du, smoother, lo, hi, nominal)
        sigma_next = state.sigma
        if cfg.adaptive_sigma:
            m2 = m2_rows.view(lead + (A_TOTAL, h)).sum(dim=-1) / h
            if group is not None:
                dist.all_reduce(m2, op=dist.ReduceOp.SUM, group=group)
            sigma_next = adapt_sigma(cfg, state.sigma, m2, sigma_base)
        return u, MPPIState(u_prev=warm, sigma=sigma_next, seed=state.seed, step=state.step + 1)

    return step
