"""MPPI cost terms of the whole-body task, as pure functions on tensors.

Port of the JAX package's ``ops/costs.py``: the terms the whole-body,
drone and arm solves sum, and the arm task's :class:`ArmCostParams` /
:func:`arm_total_cost`.  Conventions: sample trajectories carry shape
[..., K, H, ...]; every term returns the per-sample cost S of shape [..., K].
Orientation errors default to the reference's metric, the norm of the ZYX
euler extraction of the error rotation (``ori_mode="euler_zyx"``), as in the
JAX package; ``"log"`` is the geodesic rotation-vector norm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..utils import rotations as rot

Tensor = torch.Tensor


def _discount(gamma: float, horizon: int, like: Tensor) -> Tensor:
    return gamma ** torch.arange(horizon, dtype=like.dtype, device=like.device)


def _error_vector(err_q: Tensor, mode: str) -> Tensor:
    if mode == "euler_zyx":
        return rot.matrix_to_euler(rot.quat_to_matrix(err_q), "ZYX")
    if mode == "log":
        return rot.quat_to_axis_angle(err_q)
    raise ValueError(f"unknown orientation error mode {mode!r}")


def orientation_error_norm(ee_rot: Tensor, target_rot: Tensor, mode: str = "euler_zyx") -> Tensor:
    """|error(R, R*)| with the error rotation R^T R* (rotation matrices)."""
    err = ee_rot.transpose(-1, -2) @ target_rot
    if mode == "euler_zyx":
        vec = rot.matrix_to_euler(err, "ZYX")
    elif mode == "log":
        vec = rot.quat_to_axis_angle(rot.matrix_to_quat(err))
    else:
        raise ValueError(f"unknown orientation error mode {mode!r}")
    return torch.linalg.norm(vec, dim=-1)


def orientation_error_norm_quat(
    ee_quat: Tensor, target_quat: Tensor, mode: str = "euler_zyx"
) -> Tensor:
    """|error(q, q*)| with the error rotation conj(q_ee) * q_target.

    ``log`` is the geodesic rotation-vector norm; ``euler_zyx`` the norm of
    the ZYX euler extraction of the error rotation."""
    err_q = rot.quat_multiply(rot.quat_conjugate(ee_quat), target_quat)
    return torch.linalg.norm(_error_vector(err_q, mode), dim=-1)


def pose_stage_cost_pq(
    ee_pos: Tensor, ee_quat: Tensor, target_pos: Tensor, target_quat: Tensor,
    w_pos: float, w_ori: float, ori_mode: str = "euler_zyx",
) -> Tensor:
    """Sum over t = 0..H-2 of w_pos*|dp|_2 + w_ori*|dori|."""
    dp = torch.linalg.norm(ee_pos[..., :-1, :] - target_pos, dim=-1)
    dori = orientation_error_norm_quat(ee_quat[..., :-1, :], target_quat, ori_mode)
    return torch.sum(w_pos * dp + w_ori * dori, dim=-1)


def pose_terminal_cost_pq(
    ee_pos: Tensor, ee_quat: Tensor, target_pos: Tensor, target_quat: Tensor,
    w_pos: float, w_ori: float, ori_mode: str = "euler_zyx",
) -> Tensor:
    """Terminal-step pose cost w_pos*|dp| + w_ori*|dori| at t = H-1."""
    dp = torch.linalg.norm(ee_pos[..., -1, :] - target_pos, dim=-1)
    dori = orientation_error_norm_quat(ee_quat[..., -1, :], target_quat, ori_mode)
    return w_pos * dp + w_ori * dori


def pose_stage_cost(
    ee_pos: Tensor, ee_rot: Tensor, target_pos: Tensor, target_rot: Tensor,
    w_pos: float, w_ori: float, ori_mode: str = "euler_zyx",
) -> Tensor:
    """Rotation-matrix form of :func:`pose_stage_cost_pq`: ee_rot
    [..., H, 3, 3]."""
    dp = torch.linalg.norm(ee_pos[..., :-1, :] - target_pos, dim=-1)
    dori = orientation_error_norm(ee_rot[..., :-1, :, :], target_rot, ori_mode)
    return torch.sum(w_pos * dp + w_ori * dori, dim=-1)


def pose_terminal_cost(
    ee_pos: Tensor, ee_rot: Tensor, target_pos: Tensor, target_rot: Tensor,
    w_pos: float, w_ori: float, ori_mode: str = "euler_zyx",
) -> Tensor:
    """Rotation-matrix form of :func:`pose_terminal_cost_pq`."""
    dp = torch.linalg.norm(ee_pos[..., -1, :] - target_pos, dim=-1)
    dori = orientation_error_norm(ee_rot[..., -1, :, :], target_rot, ori_mode)
    return w_pos * dp + w_ori * dori


def position_stage_cost(traj: Tensor, target: Tensor, weight: float) -> Tensor:
    """weight * sum_{t<H-1} |p_t - p*|^2."""
    err = traj[..., :-1, :] - target
    return weight * torch.sum(err * err, dim=(-1, -2))


def position_terminal_cost(traj: Tensor, target: Tensor, weight: float) -> Tensor:
    """weight * |p_{H-1} - p*|^2."""
    err = traj[..., -1, :] - target
    return weight * torch.sum(err * err, dim=-1)


def covariance_cost(u: Tensor, v: Tensor, sigma_inv: Tensor, weight: float, lam: float,
                    alpha: float) -> Tensor:
    """The information-theoretic cross term weight * lambda (1 - alpha)
    sum_t u_t^T Sigma^-1 v_t: u [..., H, A] the nominal controls, v
    [..., K, H, A] the samples, sigma_inv (A, A)."""
    quad = torch.sum((u @ sigma_inv)[..., None, :, :] * v, dim=-1)
    return weight * (lam * (1.0 - alpha)) * torch.sum(quad, dim=-1)


def action_cost(v: Tensor, weight: float, gamma: float) -> Tensor:
    """weight * sum_t gamma^t |u_t|^2."""
    g = _discount(gamma, v.shape[-2], v)
    return weight * torch.sum(torch.sum(v * v, dim=-1) * g, dim=-1)


def centering_cost(q: Tensor, q_center: Tensor, weight: float, gamma: float) -> Tensor:
    """Keep the joints near mid-range: weight * sum_t gamma^t |q_t - q_c|^2."""
    g = _discount(gamma, q.shape[-2], q)
    d = q - q_center
    return weight * torch.sum(torch.sum(d * d, dim=-1) * g, dim=-1)


def joint_tracking_cost(q: Tensor, q_ref: Tensor, weight: float, gamma: float) -> Tensor:
    """Track a reference joint trajectory: weight * sum_t gamma^t |q_t - q_ref_t|^2."""
    g = _discount(gamma, q.shape[-2], q)
    d = q - q_ref
    return weight * torch.sum(torch.sum(d * d, dim=-1) * g, dim=-1)


def joint_limit_cost(
    q: Tensor, lower: Tensor, upper: Tensor, gamma: float, penalty: float = 1e10,
) -> Tensor:
    """Hard out-of-bounds penalty per offending step (any joint), discounted."""
    g = _discount(gamma, q.shape[-2], q)
    out = torch.any((q < lower) | (q > upper), dim=-1)
    return torch.sum(out.to(q.dtype) * penalty * g, dim=-1)


def joint_limit_soft_cost(
    q: Tensor, lower: Tensor, upper: Tensor, gamma: float, weight: float = 1e3,
) -> Tensor:
    """Quadratic boundary-violation cost weight * sum_t gamma^t sum_j viol^2."""
    g = _discount(gamma, q.shape[-2], q)
    viol = torch.clamp(lower - q, min=0.0) + torch.clamp(q - upper, min=0.0)
    return weight * torch.sum(torch.sum(viol * viol, dim=-1) * g, dim=-1)


def sphere_obstacle_cost(
    points: Tensor, centers: Tensor, radii: Tensor, weight: float,
    margin: float = 0.0,
) -> Tensor:
    """Squared penetration depth of points [..., H, 3] into spheres
    (centers (O, 3), radii (O,)), summed over obstacles and steps."""
    d = torch.linalg.norm(points[..., None, :] - centers, dim=-1)  # [..., H, O]
    pen = torch.clamp(radii + margin - d, min=0.0)
    return weight * torch.sum(pen * pen, dim=(-1, -2))


@dataclass(frozen=True)
class ArmCostParams:
    """Weights of the arm task's cost stack (the JAX package's defaults: the
    pose terms on; a zero weight disables a term)."""

    stage_pose_weight: float = 50.0
    stage_orientation_weight: float = 30.0
    terminal_pose_weight: float = 40.0
    terminal_orientation_weight: float = 30.0
    covar_weight: float = 0.0
    action_weight: float = 0.0
    centering_weight: float = 0.0
    joint_tracking_weight: float = 0.0
    joint_limit_weight: float = 0.0  # 1 enables the 1e10 penalty
    gamma: float = 0.98
    alpha: float = 0.1
    ori_mode: str = "euler_zyx"


def arm_total_cost(
    params: ArmCostParams, lam: float, ee_pos: Tensor, ee_rot: Tensor, q_samples: Tensor,
    v_samples: Tensor, u_prev: Tensor, sigma_inv: Tensor, target_pos: Tensor,
    target_rot: Tensor, q_center: Tensor, q_lower: Tensor, q_upper: Tensor,
    q_ref: Optional[Tensor] = None,
) -> Tensor:
    """Total per-sample cost S, summing exactly the enabled terms (rotation
    matrices ee_rot [..., K, H, 3, 3])."""
    s = pose_stage_cost(ee_pos, ee_rot, target_pos, target_rot, params.stage_pose_weight,
                        params.stage_orientation_weight, params.ori_mode)
    s = s + pose_terminal_cost(ee_pos, ee_rot, target_pos, target_rot,
                               params.terminal_pose_weight,
                               params.terminal_orientation_weight, params.ori_mode)
    if params.covar_weight:
        s = s + covariance_cost(u_prev, v_samples, sigma_inv, params.covar_weight, lam,
                                params.alpha)
    if params.action_weight:
        s = s + action_cost(v_samples, params.action_weight, params.gamma)
    if params.centering_weight:
        s = s + centering_cost(q_samples, q_center, params.centering_weight, params.gamma)
    if params.joint_tracking_weight and q_ref is not None:
        s = s + joint_tracking_cost(q_samples, q_ref, params.joint_tracking_weight,
                                    params.gamma)
    if params.joint_limit_weight:
        s = s + params.joint_limit_weight * joint_limit_cost(q_samples, q_lower, q_upper,
                                                             params.gamma)
    return s
