"""MPPI cost terms of the whole-body task, as pure functions on tensors.

Port of the subset of the JAX package's ``ops/costs.py`` that the
whole-body solve sums.  Conventions: sample trajectories carry shape
[..., K, H, ...]; every term returns the per-sample cost S of shape [..., K].
"""

from __future__ import annotations

import torch

from ..utils import rotations as rot

Tensor = torch.Tensor


def _discount(gamma: float, horizon: int, like: Tensor) -> Tensor:
    return gamma ** torch.arange(horizon, dtype=like.dtype, device=like.device)


def orientation_error_norm_quat(
    ee_quat: Tensor, target_quat: Tensor, mode: str = "log"
) -> Tensor:
    """|error(q, q*)| with the error rotation conj(q_ee) * q_target.

    ``log`` is the geodesic rotation-vector norm; ``euler_zyx`` the norm of
    the ZYX euler extraction of the error rotation."""
    err_q = rot.quat_multiply(rot.quat_conjugate(ee_quat), target_quat)
    if mode == "euler_zyx":
        vec = rot.matrix_to_euler(rot.quat_to_matrix(err_q), "ZYX")
    elif mode == "log":
        vec = rot.quat_to_axis_angle(err_q)
    else:
        raise ValueError(f"unknown orientation error mode {mode!r}")
    return torch.linalg.norm(vec, dim=-1)


def pose_stage_cost_pq(
    ee_pos: Tensor, ee_quat: Tensor, target_pos: Tensor, target_quat: Tensor,
    w_pos: float, w_ori: float, ori_mode: str = "log",
) -> Tensor:
    """Sum over t = 0..H-2 of w_pos*|dp|_2 + w_ori*|dori|."""
    dp = torch.linalg.norm(ee_pos[..., :-1, :] - target_pos, dim=-1)
    dori = orientation_error_norm_quat(ee_quat[..., :-1, :], target_quat, ori_mode)
    return torch.sum(w_pos * dp + w_ori * dori, dim=-1)


def pose_terminal_cost_pq(
    ee_pos: Tensor, ee_quat: Tensor, target_pos: Tensor, target_quat: Tensor,
    w_pos: float, w_ori: float, ori_mode: str = "log",
) -> Tensor:
    """Terminal-step pose cost w_pos*|dp| + w_ori*|dori| at t = H-1."""
    dp = torch.linalg.norm(ee_pos[..., -1, :] - target_pos, dim=-1)
    dori = orientation_error_norm_quat(ee_quat[..., -1, :], target_quat, ori_mode)
    return w_pos * dp + w_ori * dori


def position_stage_cost(traj: Tensor, target: Tensor, weight: float) -> Tensor:
    """weight * sum_{t<H-1} |p_t - p*|^2."""
    err = traj[..., :-1, :] - target
    return weight * torch.sum(err * err, dim=(-1, -2))


def action_cost(v: Tensor, weight: float, gamma: float) -> Tensor:
    """weight * sum_t gamma^t |u_t|^2."""
    g = _discount(gamma, v.shape[-2], v)
    return weight * torch.sum(torch.sum(v * v, dim=-1) * g, dim=-1)


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
