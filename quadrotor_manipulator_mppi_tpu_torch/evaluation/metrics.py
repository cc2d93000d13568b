"""Flight-quality metrics and reach-gate scoring of closed-loop episodes.

Port of the JAX package's ``evaluation/metrics.py``: the hover,
waypoint and tracking metrics (functions of tensors with leading batch
dims, so they run on the episode's device) with the reference's hover
thresholds, and the reach-gate scoring (plain NumPy on host arrays): the
debounced reach convergence and the single-episode reach quality.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# The reference's hover evaluation pass thresholds.
HOVER_POS_RMS_THRESHOLD = 0.2       # [m]
HOVER_ANG_RATE_THRESHOLD = 0.2      # [rad/s]


class HoverMetrics(NamedTuple):
    pos_rms: Tensor        # windowed RMS position error [m]
    ang_rate_rms: Tensor   # windowed RMS angular rate [rad/s]
    settling_time: Tensor  # first time the error stays inside the radius [s]
    passed: Tensor         # bool against the reference thresholds


def rms(x: Tensor, axis=None) -> Tensor:
    return torch.sqrt(torch.mean(x * x) if axis is None else torch.mean(x * x, dim=axis))


def position_rms_error(pos: Tensor, target: Tensor) -> Tensor:
    """RMS of |p_t - p*| over the trajectory's time axis (pos: [..., T, 3])."""
    return torch.sqrt(torch.mean(torch.sum((pos - target) ** 2, dim=-1), dim=-1))


def settling_time(pos: Tensor, target: Tensor, dt: float, radius: float = 0.1) -> Tensor:
    """Earliest time after which the position error never leaves
    ``radius``; T*dt if it never settles."""
    err = torch.linalg.norm(pos - target, dim=-1)  # [..., T]
    t_idx = torch.arange(err.shape[-1], device=err.device)
    last_outside = torch.where(err > radius, t_idx, -1).max(dim=-1).values
    return (last_outside + 1).to(pos.dtype) * dt


def hover_metrics(pos: Tensor, ang_rate: Tensor, target: Tensor, dt: float,
                  window_start_frac: float = 0.5) -> HoverMetrics:
    """Evaluate a hover log (pos, ang_rate: [T, 3]) over the trailing
    window."""
    t0 = int(pos.shape[-2] * window_start_frac)
    pos_rms = position_rms_error(pos[..., t0:, :], target)
    rate_rms = rms(torch.linalg.norm(ang_rate[..., t0:, :], dim=-1), axis=-1)
    passed = (pos_rms <= HOVER_POS_RMS_THRESHOLD) & (rate_rms <= HOVER_ANG_RATE_THRESHOLD)
    return HoverMetrics(pos_rms=pos_rms, ang_rate_rms=rate_rms,
                        settling_time=settling_time(pos, target, dt), passed=passed)


def waypoint_response(pos: Tensor, waypoint: Tensor, dt: float, radius: float = 0.1) -> Tensor:
    """Time to first enter the waypoint radius; T*dt if never reached."""
    err = torch.linalg.norm(pos - waypoint, dim=-1)
    t_idx = torch.arange(err.shape[-1], device=err.device)
    first = torch.where(err <= radius, t_idx, err.shape[-1]).min(dim=-1).values
    return first.to(pos.dtype) * dt


def tracking_rmse(actual: Tensor, reference: Tensor) -> Tensor:
    """Trajectory-tracking RMSE over the time axis (-2)."""
    return torch.sqrt(torch.mean(torch.sum((actual - reference) ** 2, dim=-1), dim=-1))


def reach_convergence(err, gate: float = 0.005, hold_ticks: int = 50):
    """Debounced reach convergence: the first step from which ``err < gate``
    holds ``hold_ticks`` consecutive steps (a single grazing dip does not
    count).  Returns ``(converged_step, held_fraction_after)``, or
    ``(-1, 0.0)`` when the episode never converges."""
    r = np.asarray(err) < gate
    run = 0
    for i, hit in enumerate(r):
        run = run + 1 if hit else 0
        if run >= hold_ticks:
            conv = i - hold_ticks + 1
            return conv, float(r[conv:].mean())
    return -1, 0.0


def episode_quality(l1_cmd, l1_meas, tail_n, gate=0.005):
    """Reach quality of one episode: the first step the reach gate (L1 of
    the commanded EE position < 5 mm) is met and the fraction held after
    it, the debounced convergence step with the fraction held after it,
    and tail statistics of the commanded and the measured EE error."""
    l1_cmd = np.asarray(l1_cmd)
    l1_meas = np.asarray(l1_meas)
    tail = slice(-tail_n, None)
    reached = l1_cmd < gate
    first = int(np.argmax(reached)) if reached.any() else -1
    held = float(reached[first:].mean()) if first >= 0 else 0.0
    conv, held_conv = reach_convergence(l1_cmd, gate)
    return {
        "reach_gate_first_step": first,
        "held_fraction_after_reach": round(held, 3),
        "converged_step": conv,
        "held_fraction_after_converge": round(held_conv, 3),
        "l1_cmd_tail_mean_mm": round(float(l1_cmd[tail].mean()) * 1000, 2),
        "l1_cmd_tail_max_mm": round(float(l1_cmd[tail].max()) * 1000, 2),
        "l1_meas_tail_mean_mm": round(float(l1_meas[tail].mean()) * 1000, 2),
        "l1_meas_tail_max_mm": round(float(l1_meas[tail].max()) * 1000, 2),
    }
