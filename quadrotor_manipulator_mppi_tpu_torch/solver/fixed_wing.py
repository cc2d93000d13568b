"""Fixed-wing waypoint MPPI preset.

Port of the JAX package's ``solver/fixed_wing.py``: the MPPI engine flies
the Techpod.  Samples are normalized surface commands [aileron
differential, elevator, rudder, throttle offset] rolled out through the
polynomial airframe model (``models/fixed_wing``), one :func:`step
<..models.fixed_wing.step>` per horizon step: a Python loop of H steps,
each over all K samples at once (the JAX package scans it).  On the card
the loop runs inside the captured control step, so a replay launches its
few thousand small kernels at once.

Costs: horizontal and vertical waypoint progress, closest approach along
the horizon (the flyby objective: a fixed-wing cannot hover), altitude
hold, cruise airspeed, bank and rate regularization, action size, and a
ground-crash barrier.  The rollout clamps velocity and body rates to a
generous envelope, and a non-finite cost becomes the crash penalty, so one
wild sample cannot poison the softmin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import torch

from ..models import fixed_wing as fw
from ..utils import rotations as rot
from ..utils.device import resolve_device
from .mppi import MPPIConfig, MPPIState, init_state, make_step

Tensor = torch.Tensor


class FwObs(NamedTuple):
    state: fw.FixedWingState  # current (unbatched) plant state
    target: Tensor            # (3,) waypoint, world frame
    cruise_speed: Tensor      # () [m/s]


class FwOutput(NamedTuple):
    controls: fw.FwControls   # next tick's surface commands (normalized)
    u_seq: Tensor             # (H, 4) updated plan


@dataclass(frozen=True)
class FwMPPIParams:
    mppi: MPPIConfig = field(
        default_factory=lambda: MPPIConfig(
            n_samples=1024, n_horizon=40, n_action=4, dt=0.05, lam=0.05,
            sigma=(0.25, 0.25, 0.2, 0.15), savgol_window=5, savgol_polyorder=2,
            shift_warm_start=True, u_min=(-1.0, -1.0, -1.0, -0.5), u_max=(1.0, 1.0, 1.0, 0.5),
        )
    )
    aero: fw.FwAeroParams = field(default_factory=fw.FwAeroParams)
    veh: fw.FwVehicleParams = field(default_factory=fw.FwVehicleParams)
    base_throttle: float = 0.5
    w_waypoint: float = 4.0       # stage horizontal+vertical distance
    w_closest: float = 400.0      # closest approach (the flyby objective)
    w_altitude: float = 8.0
    w_speed: float = 2.0
    w_bank: float = 40.0
    w_rate: float = 2.0
    w_action: float = 0.5
    crash_z: float = 5.0          # altitude floor [m]
    crash_penalty: float = 1e6


def controls_of(v: Tensor, base_throttle: float) -> fw.FwControls:
    """Map a (..., 4) action vector onto surface commands."""
    ail = torch.clamp(v[..., 0], -1.0, 1.0)
    return fw.FwControls(aileron_left=ail, aileron_right=-ail,
                         elevator=torch.clamp(v[..., 1], -1.0, 1.0), flap=torch.zeros_like(ail),
                         rudder=torch.clamp(v[..., 2], -1.0, 1.0),
                         throttle=torch.clamp(base_throttle + v[..., 3], 0.0, 1.0))


def make_fixed_wing_solver(params: FwMPPIParams = FwMPPIParams(), device="cuda"):
    """Returns ``(step, init)``: ``step(state, obs, z=None) -> (FwOutput,
    state)`` and ``init(seed, dtype=torch.float32) -> MPPIState`` on
    ``device``.  ``z`` optionally carries the step's standard normals
    (K, H, 4) in place of the Philox stream."""
    dev = resolve_device(device)
    cfg = params.mppi

    def rollout(v: Tensor, obs: FwObs):
        k = v.shape[0]
        s = fw.FixedWingState(*(x.expand((k,) + x.shape) for x in obs.state))
        pos, vel, quat, omega = [], [], [], []
        for t in range(v.shape[1]):
            s = fw.step(params.aero, params.veh, s, controls_of(v[:, t], params.base_throttle),
                        cfg.dt)
            # The rollout's flight envelope: full deflection held over the
            # horizon can spin the explicit-Euler airframe into a V^2-force
            # blow-up; the optimum lies far inside these bounds.
            s = s._replace(vel=torch.clamp(s.vel, -60.0, 60.0),
                           omega=torch.clamp(s.omega, -12.0, 12.0))
            pos.append(s.pos)
            vel.append(s.vel)
            quat.append(s.quat)
            omega.append(s.omega)
        return tuple(torch.stack(x, dim=1) for x in (pos, vel, quat, omega))

    def cost(aux, v: Tensor, u_prev: Tensor, obs: FwObs) -> Tensor:
        pos, vel, quat, omega = aux
        dist = torch.linalg.norm(pos - obs.target, dim=-1)                # (K, H)
        s = params.w_waypoint * torch.sum(dist, dim=-1)
        s = s + params.w_closest * torch.amin(dist, dim=-1)
        s = s + params.w_altitude * torch.sum(torch.abs(pos[..., 2] - obs.target[2]), dim=-1)
        speed = torch.linalg.norm(vel, dim=-1)
        s = s + params.w_speed * torch.sum((speed - obs.cruise_speed) ** 2, dim=-1)
        # Bank: the world-z component of the body-y (left-wing) axis, R[2, 1].
        m = rot.quat_to_matrix(quat)
        s = s + params.w_bank * torch.sum(m[..., 2, 1] ** 2, dim=-1)
        s = s + params.w_rate * torch.sum(omega * omega, dim=(-1, -2))
        s = s + params.w_action * torch.sum(v * v, dim=(-1, -2))
        crashed = torch.any(pos[..., 2] < params.crash_z, dim=-1)
        s = s + params.crash_penalty * crashed.to(s.dtype)
        # A non-finite rollout must lose, not poison the softmin.
        return torch.where(torch.isfinite(s), s, params.crash_penalty)

    inner = make_step(cfg, rollout, cost)

    def step(state: MPPIState, obs: FwObs, z=None) -> Tuple[FwOutput, MPPIState]:
        u_seq, new_state = inner(state, obs, z)
        return FwOutput(controls=controls_of(u_seq[0], params.base_throttle),
                        u_seq=u_seq), new_state

    def init(seed, dtype=torch.float32) -> MPPIState:
        return init_state(cfg, seed, dtype, dev)

    return step, init
