"""The whole-body MPPI solve on two hand-written CUDA kernels.

Port of the JAX package's ``ops/pallas/whole_body_kernel.py`` (its
single-device path).  Per solve:

* :func:`wb_cost` (pass 1, ``csrc/whole_body_kernel.cu``) draws the noise
  (Philox, spilled to device memory as (A, H, K)) or reads explicit noise,
  rolls out base + arm, runs the 7-joint FK and the whole cost stack, and
  writes the per-sample cost S and per-block softmin partials (min, sum exp);
* :func:`wb_update` (pass 2) forms the softmin weights from those partials
  and reduces the weighted noise sum du and the weighted second moment per
  (action, step) row.

Between and after them only (H, A)-sized work runs in plain PyTorch:
reshaping du, the Savitzky-Golay matmul, the clamp, the warm start and the
adaptive-sigma update.  What the kernels need from the observation is
packed into one 54-float vector (:func:`pack_scalars`).

Each wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors it runs its plain version (:func:`wb_cost_plain`,
:func:`wb_update_plain`), which the CPU tests use and which the on-card
checks hold the kernels against.  ``wb_cost.launches`` and
``wb_update.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ...models import kinova
from ...models.chain import REVOLUTE, matrix_to_quat_np
from ...models.multirotor import Multirotor12State
from ...models.whole_body import WholeBodyState, _attitude_response_pair, _quat_from_rpy
from ...ops import sampling
from ...solver.mppi import (
    MPPIState, _diag_sigma, action_bounds, adapt_sigma, nominal_sequence, update_tail,
)
from ...utils import rotations as rot
from ...utils import savgol
from ...utils.device import resolve_device
from ...utils.pose import Pose
from . import build

Tensor = torch.Tensor

A_TOTAL = 4 + kinova.N_JOINTS  # 11
BLOCK = 64                     # samples per wb_cost block (WB_BLOCK)
MAX_OBSTACLES = 16             # WB_MAX_OBS
MODES = {"attitude": 0, "position": 1, "wrench": 2}
_SMEM_LIMIT = 48 * 1024        # default dynamic shared memory per block

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
        ("obs", (_F * 4) * MAX_OBSTACLES),
    ]


@dataclass(frozen=True, eq=False)
class WbKernelConfig:
    """A configuration compiled for the kernels: sizes plus the by-value
    parameter struct.  Built once per solver (:func:`make_kernel_config`)."""

    params: Any            # solver.whole_body.WholeBodyMPPIParams
    n_samples: int
    n_horizon: int
    n_blocks: int
    inv_lam: float
    struct: WbParams


def _fill(arr, values) -> None:
    for i, v in enumerate(values):
        arr[i] = float(v)


def make_kernel_config(params) -> WbKernelConfig:
    """Validate ``params`` for the kernels (the JAX kernel's checks, same
    messages) and build the constant struct."""
    cfg, mp, cp = params.mppi, params.model, params.cost
    h, k, dt = cfg.n_horizon, cfg.n_samples, cfg.dt
    if cfg.n_action != A_TOTAL:
        raise ValueError(f"whole-body kernel expects {A_TOTAL} actions")
    if k % BLOCK:
        raise ValueError(f"local sample count must be a multiple of {BLOCK}")
    if mp.control_mode not in MODES:
        raise ValueError("unknown control mode for the fused kernel")
    if cp.ori_mode != "log":
        raise ValueError("fused kernel implements the 'log' orientation metric")
    if cfg.zero_mean_noise:
        raise ValueError("zero_mean_noise unsupported in the fused kernel")
    if cfg.adaptive_sigma and cfg.sigma_scale_fn is not None:
        raise ValueError("adaptive_sigma and sigma_scale_fn are exclusive")
    if np.ndim(cfg.sigma) == 2:
        raise ValueError("fused kernel requires scalar or diagonal sigma")
    if mp.control_mode in ("attitude", "wrench") and not mp.time_parallel:
        raise ValueError("fused kernel is parallel-in-time only")
    if mp.arm_tip != "link_7":
        raise ValueError("fused kernel bakes the link_7 tip frame")
    spec = mp.chain()
    if (not np.allclose(spec.tip_rot, np.eye(3)) or not np.allclose(spec.tip_trans, 0.0)
            or np.any(spec.joint_type != REVOLUTE)
            or not np.allclose(spec.axis, [0.0, 0.0, 1.0])):
        raise ValueError("fused kernel expects revolute +z joints and an identity tip")
    if len(cp.obstacle_centers) > MAX_OBSTACLES:
        raise ValueError(f"fused kernel carries at most {MAX_OBSTACLES} obstacles")
    if (SC_LEN + h * A_TOTAL) * 4 > _SMEM_LIMIT:
        raise ValueError("horizon too long for the kernel's shared-memory warm start")

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
    for o, (c, r) in enumerate(zip(cp.obstacle_centers, cp.obstacle_radii)):
        _fill(s.obs[o], (*c, r))
    return WbKernelConfig(params=params, n_samples=k, n_horizon=h,
                          n_blocks=k // BLOCK, inv_lam=s.inv_lam, struct=s)


# ---------------------------------------------------------------------------
# Observation <-> scalar pack
# ---------------------------------------------------------------------------

def pack_scalars(obs, sigma_live: Tensor) -> Tensor:
    """The kernels' per-solve inputs from the observation (54 floats):
    q0, qd0, pos0, vel0, EE target pose, base target, live sigma, rpy0,
    omega0, and the initial attitude quaternion and base-frame gravity."""
    st = obs.state
    rpy = st.base.rpy.to(torch.float32)
    bq0 = _quat_from_rpy(rpy)
    g_b = -9.81 * rot.quat_to_matrix(bq0)[2, :]
    parts = (st.q, st.qdot, st.base.pos, st.base.vel, obs.ee_target.position,
             obs.ee_target.quat, obs.base_target, sigma_live, rpy, st.base.omega,
             bq0, g_b)
    return torch.cat([p.to(torch.float32).reshape(-1) for p in parts])


def obs_from_scalars(sc: Tensor):
    """Inverse of :func:`pack_scalars` (the observation part)."""
    from ...solver.whole_body import WholeBodyObs

    base = Multirotor12State(
        pos=sc[SC_POS0:SC_POS0 + 3], rpy=sc[SC_RPY0:SC_RPY0 + 3],
        vel=sc[SC_VEL0:SC_VEL0 + 3], omega=sc[SC_OM0:SC_OM0 + 3],
    )
    return WholeBodyObs(
        state=WholeBodyState(base=base, q=sc[SC_Q0:SC_Q0 + 7], qdot=sc[SC_QD0:SC_QD0 + 7]),
        ee_target=Pose(position=sc[SC_TPOS:SC_TPOS + 3], quat=sc[SC_TQUAT:SC_TQUAT + 4]),
        base_target=sc[SC_BTGT:SC_BTGT + 3],
    )


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load_library("whole_body_kernel")
    vp = ctypes.c_void_p
    lib.wb_cost_launch.argtypes = [ctypes.POINTER(WbParams), vp, vp, vp, vp, vp, vp,
                                   ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int, vp]
    lib.wb_cost_launch.restype = ctypes.c_int
    lib.wb_update_launch.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float, vp, vp, vp]
    lib.wb_update_launch.restype = ctypes.c_int
    return lib


def _check(t: Tensor, shape, device, name: str) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor of shape {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def wb_cost(kc: WbKernelConfig, sc: Tensor, u_prev: Tensor, eps: Optional[Tensor] = None,
            seed: int = 0, step: int = 0) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Pass 1.  Returns (S (K,), block minima (n_blocks,), block sums of
    exp((m - S)/lambda) (n_blocks,), eps (A, H, K)).  With ``eps=None`` the
    noise is the Philox stream of (seed, step) scaled by the packed sigma,
    and is returned; otherwise ``eps`` is read."""
    if sc.device.type == "cpu":
        return wb_cost_plain(kc, sc, u_prev, eps, seed, step)
    k, h, dev = kc.n_samples, kc.n_horizon, sc.device
    _check(sc, (SC_LEN,), dev, "sc")
    _check(u_prev, (h, A_TOTAL), dev, "u_prev")
    draw = eps is None
    if draw:
        eps = torch.empty((A_TOTAL, h, k), dtype=torch.float32, device=dev)
    _check(eps, (A_TOTAL, h, k), dev, "eps")
    s = torch.empty(k, dtype=torch.float32, device=dev)
    m_part = torch.empty(kc.n_blocks, dtype=torch.float32, device=dev)
    e_part = torch.empty(kc.n_blocks, dtype=torch.float32, device=dev)
    rc = _lib().wb_cost_launch(
        ctypes.byref(kc.struct), sc.data_ptr(), u_prev.data_ptr(), eps.data_ptr(),
        s.data_ptr(), m_part.data_ptr(), e_part.data_ptr(),
        int(seed) & 0xFFFFFFFFFFFFFFFF, int(step) & 0xFFFFFFFF, int(draw),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "wb_cost")
    wb_cost.launches += 1
    return s, m_part, e_part, eps


wb_cost.launches = 0


def wb_cost_plain(kc: WbKernelConfig, sc: Tensor, u_prev: Tensor,
                  eps: Optional[Tensor] = None, seed: int = 0,
                  step: int = 0) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of :func:`wb_cost`: the operator-form rollout and cost
    stack of ``solver/whole_body`` on v = u_prev + eps, then the per-block
    softmin partials."""
    from ...solver.whole_body import rollout_cost_fns

    k, h = kc.n_samples, kc.n_horizon
    if eps is None:
        z = sampling.philox_normals(seed, step, k, h, A_TOTAL, sc.device)
        eps = z * sc[SC_SIGMA:SC_SIGMA + A_TOTAL].view(A_TOTAL, 1, 1)
    v = u_prev[None] + eps.permute(2, 1, 0)
    obs = obs_from_scalars(sc)
    rollout_fn, cost_fn = rollout_cost_fns(kc.params)
    s = cost_fn(rollout_fn(v, obs), v, u_prev, obs)
    blk = s.view(kc.n_blocks, BLOCK)
    m = blk.min(dim=1).values
    e = torch.exp((m[:, None] - blk) * kc.inv_lam).sum(dim=1)
    return s, m, e, eps


def wb_update(kc: WbKernelConfig, eps: Tensor, s: Tensor, m_part: Tensor,
              e_part: Tensor) -> Tuple[Tensor, Tensor]:
    """Pass 2.  Softmin weights w = exp((rho - S)/lambda)/eta from the block
    partials; returns (du, m2), each (A*H,) over the rows (a, t) of eps:
    du = sum_k w_k eps_k and m2 = sum_k w_k eps_k^2."""
    if eps.device.type == "cpu":
        return wb_update_plain(kc, eps, s, m_part, e_part)
    k, h, dev = kc.n_samples, kc.n_horizon, eps.device
    rows = A_TOTAL * h
    _check(eps, (A_TOTAL, h, k), dev, "eps")
    _check(s, (k,), dev, "s")
    _check(m_part, (kc.n_blocks,), dev, "m_part")
    _check(e_part, (kc.n_blocks,), dev, "e_part")
    du = torch.empty(rows, dtype=torch.float32, device=dev)
    m2 = torch.empty(rows, dtype=torch.float32, device=dev)
    rc = _lib().wb_update_launch(
        eps.data_ptr(), s.data_ptr(), m_part.data_ptr(), e_part.data_ptr(),
        kc.n_blocks, k, rows, kc.inv_lam, du.data_ptr(), m2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "wb_update")
    wb_update.launches += 1
    return du, m2


wb_update.launches = 0


def wb_update_plain(kc: WbKernelConfig, eps: Tensor, s: Tensor, m_part: Tensor,
                    e_part: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`wb_update`: the softmin from the partials,
    the weighted sum and the weighted second moment."""
    rho = m_part.min()
    eta = torch.sum(e_part * torch.exp((rho - m_part) * kc.inv_lam))
    w = torch.exp((rho - s) * kc.inv_lam) / eta
    flat = eps.reshape(A_TOTAL * kc.n_horizon, kc.n_samples)
    return flat @ w, (flat * flat) @ w


# ---------------------------------------------------------------------------
# The solve step
# ---------------------------------------------------------------------------

def make_whole_body_cuda_step(params, device="cuda"):
    """Build ``step(state, obs, z=None) -> (u_seq, new_state)`` on the two
    kernels.  ``z``: optional standard normals (K, H, A), the layout of
    ``sampling.sample_noise``, used instead of the Philox stream."""
    dev = resolve_device(device)
    kc = make_kernel_config(params)
    cfg = params.mppi
    h = cfg.n_horizon
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
        if cfg.sigma_scale_fn is not None:
            sigma_live = sigma_live * cfg.sigma_scale_fn(obs)
        sc = pack_scalars(obs, sigma_live)
        u_prev = state.u_prev.to(torch.float32).contiguous()
        eps = None
        if z is not None:
            z = torch.as_tensor(z, dtype=torch.float32, device=dev)
            eps = (z * sigma_live).permute(2, 1, 0).contiguous()
        s, m_part, e_part, eps = wb_cost(kc, sc, u_prev, eps, state.seed, state.step)
        du_rows, m2_rows = wb_update(kc, eps, s, m_part, e_part)
        du = du_rows.view(A_TOTAL, h).T
        u, warm = update_tail(cfg, u_prev, du, smoother, lo, hi, nominal)
        sigma_next = state.sigma
        if cfg.adaptive_sigma:
            m2 = m2_rows.view(A_TOTAL, h).sum(dim=1) / h
            sigma_next = adapt_sigma(cfg, state.sigma, m2, sigma_base)
        return u, MPPIState(u_prev=warm, sigma=sigma_next, seed=state.seed,
                            step=state.step + 1)

    return step
