"""Smooth reference-trajectory generators (cubic time scaling).

Port of the JAX package's ``utils/trajectory.py``: cubic polynomial
interpolation with zero boundary velocities, in joint space and on SE(3)
through the so(3) log/exp maps, written as functions of a time tensor ``t``
so whole trajectories evaluate at once; the RotorS waypoint-file reader; the
natural cubic splines of a waypoint schedule (built on the host with NumPy,
sampled on any device); and the figure-eight reference.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rotations as rot
from .pose import Pose

Tensor = torch.Tensor


def cubic_timing(t: Tensor, t_start, duration) -> Tensor:
    """Cubic ease 0 -> 1 with zero end slopes, clamped outside
    [t_start, t_start + duration]."""
    s = torch.clamp((t - t_start) / duration, 0.0, 1.0)
    return 3.0 * s**2 - 2.0 * s**3


def joint_trajectory(t: Tensor, t_start, duration, q_init: Tensor, q_target: Tensor) -> Tensor:
    """Position setpoint at time(s) ``t``; broadcasts over leading dims of t."""
    alpha = cubic_timing(t, t_start, duration)
    return q_init + alpha[..., None] * (q_target - q_init)


def joint_trajectory_velocity(t: Tensor, t_start, duration, q_init: Tensor,
                              q_target: Tensor) -> Tensor:
    """Velocity setpoint of :func:`joint_trajectory` at time(s) ``t``."""
    s = torch.clamp((t - t_start) / duration, 0.0, 1.0)
    dalpha = (6.0 * s - 6.0 * s**2) / duration
    return dalpha[..., None] * (q_target - q_init)


def se3_trajectory(t: Tensor, t_start, duration, init: Pose, target: Pose) -> Pose:
    """Cubic interpolation in (translation, so(3) log) coordinates."""
    alpha = cubic_timing(t, t_start, duration)
    pos = init.position + alpha[..., None] * (target.position - init.position)
    w0 = rot.quat_to_axis_angle(init.quat)
    w1 = rot.quat_to_axis_angle(target.quat)
    w = w0 + alpha[..., None] * (w1 - w0)
    return Pose(position=pos, quat=rot.quat_from_axis_angle(w))


def read_waypoint_file(path: str):
    """Parse a RotorS waypoint file: one ``wait_time x y z yaw_deg`` line per
    waypoint, whitespace separated.  Returns NumPy arrays ``(wait_times [s],
    positions (N, 3) [m], yaws (N,) [rad])``; an incomplete trailing line is
    dropped."""
    waits, positions, yaws = [], [], []
    with open(path) as f:
        tokens = f.read().split()
    for i in range(0, len(tokens) - len(tokens) % 5, 5):
        t, x, y, z, yaw_deg = (float(v) for v in tokens[i:i + 5])
        waits.append(t)
        positions.append((x, y, z))
        yaws.append(np.deg2rad(yaw_deg))
    return (np.asarray(waits, np.float64), np.asarray(positions, np.float64),
            np.asarray(yaws, np.float64))


def cubic_spline_coeffs(times, points):
    """Natural cubic spline through waypoints, built on the host.

    ``times`` (N,) strictly increasing knot times, ``points`` (N, D).
    Returns ``(breaks (N,), coeffs (N-1, 4, D))`` with segment i valid on
    [t_i, t_{i+1}] and p(t) = sum_k coeffs[i, k] (t - t_i)^k."""
    t = np.asarray(times, np.float64)
    p = np.asarray(points, np.float64)
    if p.ndim == 1:
        p = p[:, None]
    n = len(t)
    if n < 2:
        raise ValueError("need at least two waypoints")
    h = np.diff(t)
    if np.any(h <= 0):
        raise ValueError(
            "knot times must be strictly increasing (a zero wait_time is "
            "fine for step setpoints but not for a polynomial trajectory)")
    # Knot second derivatives M (natural: M_0 = M_{N-1} = 0).
    m = np.zeros((n, p.shape[1]))
    if n > 2:
        a = np.zeros((n - 2, n - 2))
        rhs = np.zeros((n - 2, p.shape[1]))
        for i in range(1, n - 1):
            j = i - 1
            a[j, j] = 2.0 * (h[i - 1] + h[i])
            if j > 0:
                a[j, j - 1] = h[i - 1]
            if j < n - 3:
                a[j, j + 1] = h[i]
            rhs[j] = 6.0 * ((p[i + 1] - p[i]) / h[i] - (p[i] - p[i - 1]) / h[i - 1])
        m[1:-1] = np.linalg.solve(a, rhs)
    coeffs = np.zeros((n - 1, 4, p.shape[1]))
    for i in range(n - 1):
        coeffs[i, 0] = p[i]
        coeffs[i, 1] = (p[i + 1] - p[i]) / h[i] - h[i] * (2.0 * m[i] + m[i + 1]) / 6.0
        coeffs[i, 2] = m[i] / 2.0
        coeffs[i, 3] = (m[i + 1] - m[i]) / (6.0 * h[i])
    return t, coeffs


def polynomial_sample(breaks, coeffs, t: Tensor, derivative: int = 0) -> Tensor:
    """Sample a polynomial-segment trajectory at time(s) ``t``.

    ``breaks`` (N,), ``coeffs`` (N-1, K, D) in the :func:`cubic_spline_coeffs`
    layout (any order K), as tensors on ``t``'s device or host arrays; ``t``
    clamps to the trajectory's span, so sampling past the end holds the
    terminal state."""
    breaks = torch.as_tensor(breaks, dtype=t.dtype, device=t.device)
    coeffs = torch.as_tensor(coeffs, dtype=t.dtype, device=t.device)
    lead = t.shape
    t = t.reshape(-1)  # (N,) segment indices: a 0-d index tensor would be read on the host
    t = torch.clamp(t, breaks[0], breaks[-1])
    seg = torch.clamp(torch.searchsorted(breaks, t.contiguous(), right=True) - 1,
                      0, coeffs.shape[0] - 1)
    tau = t - breaks[seg]
    k = coeffs.shape[1]
    c = coeffs[seg]                                  # (..., K, D)
    # Derivative-d coefficients: c_j j!/(j-d)! on tau^(j-d), by Horner.
    out = torch.zeros_like(c[..., 0, :])
    for j in range(k - 1, derivative - 1, -1):
        fact = 1.0
        for d in range(derivative):
            fact *= (j - d)
        out = out * tau[..., None] + fact * c[..., j, :]
    return out.reshape(lead + out.shape[-1:])


def gerono_reference(t: Tensor, amp: float, omega: float, z0: float, t_ramp: float = 1.5):
    """Figure-eight (Gerono lemniscate) reference x = A sin(w tau),
    y = (A/2) sin(2 w tau) at altitude ``z0``, with the time warp
    tau = t^2 / (t + t_ramp) that starts at rest.  Returns exact
    ``(pos, vel, acc)`` references."""
    tau = t * t / (t + t_ramp)
    dtau = (t * t + 2 * t * t_ramp) / (t + t_ramp) ** 2
    ddtau = 2 * t_ramp * t_ramp / (t + t_ramp) ** 3
    s, c = torch.sin(omega * tau), torch.cos(omega * tau)
    s2, c2 = torch.sin(2 * omega * tau), torch.cos(2 * omega * tau)
    zero = torch.zeros_like(t)
    pos = torch.stack([amp * s, 0.5 * amp * s2, z0 + zero], -1)
    vel = torch.stack([amp * omega * c * dtau, amp * omega * c2 * dtau, zero], -1)
    acc = torch.stack([
        -amp * omega**2 * s * dtau**2 + amp * omega * c * ddtau,
        -2 * amp * omega**2 * s2 * dtau**2 + amp * omega * c2 * ddtau,
        zero,
    ], -1)
    return pos, vel, acc


def waypoint_splines(waits, positions, yaws):
    """C2 cubic splines through a RotorS waypoint schedule: knots at the
    cumulative wait windows, position on a natural cubic through the
    waypoints (the first knot doubled, so flight starts at the first
    waypoint), yaw on its own spline over the unwrapped yaw sequence.
    Returns ``(breaks, pos_coeffs, yaw_coeffs)`` for
    :func:`polynomial_sample`."""
    knots = np.concatenate([[0.0], np.cumsum(waits)])
    kpts = np.concatenate([positions[:1], positions], axis=0)
    breaks, coeffs = cubic_spline_coeffs(knots, kpts)
    yk = np.unwrap(np.concatenate([[0.0], yaws]))
    _, ycoeffs = cubic_spline_coeffs(knots, yk[:, None])
    return breaks, coeffs, ycoeffs
