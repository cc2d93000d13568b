"""Free-body graspable object of the pick_weight task.

Port of the JAX package's ``sim/graspable.py``.  The reference's
``worlds/pick_weight.world`` places a graspable weight on a support stand
as an independent rigid body: before the gripper closes it can be pushed
off or dropped, so the grasp depends on the approach not disturbing it.
Here the object is a point-mass free body with

* **support contact**: a penalty spring-damper with regularized Coulomb
  friction against the stand's top disc (within ``stand_radius`` of its
  axis) and the ground plane;
* **end-effector contact**: a sphere-sphere penalty between the gripper
  palm and the object, whose reaction the plant feels.  An open gripper's
  fingers straddle the object (contact radius ``ee_radius_open``); a closed
  one presents the fist (``ee_radius``);
* **grasp attach**: when the gripper is closed and the palm is within
  ``grasp_tol`` of the object, the object becomes a rigid follower of the
  end effector.

The state is three tensors, with any leading batch dims (a fleet), stepped
with semi-implicit Euler substeps inside each control tick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..utils.device import device_const

Tensor = torch.Tensor

GRAVITY = 9.80665


@dataclass(frozen=True)
class GraspableParams:
    mass: float = 0.5                      # the weight [kg]
    radius: float = 0.04                   # object bounding sphere [m]
    ee_radius: float = 0.06                # closed-gripper fist sphere [m]
    ee_radius_open: float = 0.0            # open gripper: the fingers straddle
    grasp_tol: float = 0.05                # attach reach (aperture) [m]
    # The support stand's top disc (world frame).
    stand_center_xy: Tuple[float, float] = (0.0, 0.0)
    stand_top_z: float = 0.0
    stand_radius: float = 0.25
    ground_z: float = 0.0
    # Contact law.
    stiffness: float = 3000.0              # N/m
    damping: float = 30.0                  # N s/m
    friction_mu: float = 0.8
    friction_vel_eps: float = 1e-3
    # End-effector push contact (softer: fingers, not steel).
    ee_stiffness: float = 800.0
    ee_damping: float = 10.0
    n_substeps: int = 10                   # substeps per control tick


class GraspableState(NamedTuple):
    pos: Tensor       # (..., 3) world
    vel: Tensor       # (..., 3)
    attached: Tensor  # (...) bool


def init_graspable(params: GraspableParams, pos=None, dtype=torch.float32,
                   device="cuda") -> GraspableState:
    """The object at rest on the stand top (default: on the stand's axis).
    ``pos`` (B, 3) gives B objects."""
    if pos is None:
        cx, cy = params.stand_center_xy
        pos = (cx, cy, params.stand_top_z + params.radius)
    p = torch.as_tensor(pos, dtype=dtype).to(device)
    return GraspableState(pos=p.clone(), vel=torch.zeros_like(p),
                          attached=torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device))


def _support_force(params: GraspableParams, pos: Tensor, vel: Tensor) -> Tensor:
    """Penalty contact against the stand's top disc and the ground (world)."""
    cxy = device_const(params.stand_center_xy, pos)
    on_stand = torch.linalg.norm(pos[..., :2] - cxy, dim=-1) < params.stand_radius
    support_z = torch.where(on_stand, params.stand_top_z, params.ground_z)
    pen = torch.clamp(support_z + params.radius - pos[..., 2], min=0.0)
    active = pen > 0.0
    fn = torch.clamp(params.stiffness * pen - params.damping * vel[..., 2], min=0.0) * active
    ft = -params.friction_mu * fn[..., None] * vel[..., :2] / (
        torch.linalg.norm(vel[..., :2], dim=-1, keepdim=True) + params.friction_vel_eps)
    return torch.cat([ft, fn[..., None]], dim=-1)


def _ee_push_force(params: GraspableParams, pos: Tensor, vel: Tensor, ee_pos: Tensor,
                   ee_vel: Tensor, ee_radius) -> Tensor:
    """Sphere-sphere penalty force on the object from the gripper palm."""
    d = pos - ee_pos
    dist = torch.linalg.norm(d, dim=-1, keepdim=True)
    n = d / (dist + 1e-9)
    pen = torch.clamp(params.radius + ee_radius - dist, min=0.0)
    rel_vn = torch.sum((vel - ee_vel) * n, dim=-1, keepdim=True)
    fn = torch.clamp(params.ee_stiffness * pen - params.ee_damping * rel_vn, min=0.0)
    return fn * n * (pen > 0.0)


def graspable_step(params: GraspableParams, state: GraspableState, ee_pos: Tensor,
                   ee_vel: Tensor, gripper_closed, dt: float):
    """Advance the object one control tick.

    ``ee_pos``/``ee_vel`` are the gripper palm's world position and velocity,
    held over the tick's substeps; ``gripper_closed`` a bool (or a bool
    tensor).  Returns ``(new_state, reaction_force_world)``: the mean force
    the object exerts back on the end effector over the tick (zero while
    attached: the carried load is the whole-body loop's ``payload_mass``)."""
    sub_dt = dt / params.n_substeps
    g = device_const([0.0, 0.0, -GRAVITY * params.mass], state.pos)
    if isinstance(gripper_closed, Tensor):
        ee_r = torch.where(gripper_closed, params.ee_radius, params.ee_radius_open)[..., None]
    else:
        ee_r = params.ee_radius if gripper_closed else params.ee_radius_open

    pos, vel = state.pos, state.vel
    f_push_sum = torch.zeros_like(pos)
    for _ in range(params.n_substeps):
        f_push = _ee_push_force(params, pos, vel, ee_pos, ee_vel, ee_r)
        f = g + _support_force(params, pos, vel) + f_push
        vel = vel + f / params.mass * sub_dt
        pos = pos + vel * sub_dt
        f_push_sum = f_push_sum + f_push

    # Attach: the gripper closed with the palm at the object.
    near = torch.linalg.norm(state.pos - ee_pos, dim=-1) < params.grasp_tol
    closing = (gripper_closed & near) if isinstance(gripper_closed, Tensor) else \
        (near if gripper_closed else torch.zeros_like(near))
    attached = state.attached | closing

    # While attached the object is a rigid follower of the end effector.
    held = attached[..., None]
    pos = torch.where(held, ee_pos, pos)
    vel = torch.where(held, ee_vel, vel)
    reaction = torch.where(held, 0.0, -f_push_sum / params.n_substeps)
    return GraspableState(pos=pos, vel=vel, attached=attached), reaction
