"""Primitive contact: the robot's collision spheres against world geometry.

Port of the JAX package's ``sim/contact.py``.  One penalty-spring and
regularized-Coulomb law acts between a small set of robot collision
spheres and static world primitives:

* **robot side**: the vehicle hull (a sphere at the base origin) and
  spheres at chosen joint child frames of the arm (elbow, wrist, end
  effector by default);
* **world side**: the ground plane, spheres, horizontal discs (stand tops,
  one-sided support) and vertical cylinder segments (stand columns).

Forces are computed once per control period: the world-frame force on each
sphere maps to a base wrench (force and moment about the base origin) and,
through each contact point's Jacobian, to arm joint torques, held constant
over the period's physics substeps.  Where the JAX package differentiates
the link positions (``jax.jvp``, ``jax.jacfwd``), the velocities and the
Jacobian here are the closed-form ones from the joint frames
(``models/chain.joint_frames_posquat``): joint j moves a point p at
``axis_j x (p - origin_j)`` per radian, and the base turning at body rate
omega moves it at ``R (omega x r_body)``.  Every function takes leading
batch dims (a fleet).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from ..models import chain as chain_mod
from ..models.chain import ChainSpec
from ..utils import rotations as rot
from ..utils.device import device_const

Tensor = torch.Tensor


@dataclass(frozen=True)
class WorldPrimitives:
    """Static world collision geometry (world frame)."""

    ground_z: float = 0.0
    has_ground: bool = True
    spheres: Tuple[Tuple[float, float, float, float], ...] = ()
    #   (cx, cy, cz, radius)
    discs: Tuple[Tuple[float, float, float, float], ...] = ()
    #   (cx, cy, top_z, radius): one-sided horizontal support (stand top)
    cylinders: Tuple[Tuple[float, float, float, float, float], ...] = ()
    #   (cx, cy, z_lo, z_hi, radius): vertical column segment (lateral)


@dataclass(frozen=True)
class ContactParams:
    """The contact law and the robot's collision spheres."""

    world: WorldPrimitives = field(default_factory=WorldPrimitives)
    stiffness: float = 3000.0       # N/m
    damping: float = 30.0           # N s/m
    friction_mu: float = 0.8
    friction_vel_eps: float = 1e-3
    base_radius: float = 0.35       # vehicle hull bounding sphere
    # (joint child-frame index, sphere radius): elbow (after joint 4),
    # wrist (after joint 6), end effector (after joint 7).
    link_spheres: Tuple[Tuple[int, float], ...] = ((3, 0.07), (5, 0.06), (6, 0.05))


def _contact_force(cp: ContactParams, pen: Tensor, normal: Tensor, vel: Tensor) -> Tensor:
    """Penalty normal force plus regularized Coulomb friction of one
    candidate contact; zero where pen <= 0.  ``normal`` is unit, world."""
    active = pen > 0.0
    vn = torch.sum(vel * normal, dim=-1)
    fn = torch.clamp(cp.stiffness * pen - cp.damping * vn, min=0.0) * active
    vt = vel - vn[..., None] * normal
    ft = -cp.friction_mu * fn[..., None] * vt / (
        torch.linalg.norm(vt, dim=-1, keepdim=True) + cp.friction_vel_eps)
    return fn[..., None] * normal + ft


def sphere_world_force(cp: ContactParams, p: Tensor, v: Tensor, radius: float) -> Tensor:
    """Total world-frame contact force on a moving sphere (p, radius) from
    every world primitive.  p, v (..., 3) -> (..., 3)."""
    w = cp.world
    f = torch.zeros_like(p)
    up = device_const([0.0, 0.0, 1.0], p).expand(p.shape)

    if w.has_ground:
        f = f + _contact_force(cp, w.ground_z + radius - p[..., 2], up, v)

    for cx, cy, cz, r in w.spheres:
        d = p - device_const([cx, cy, cz], p)
        dist = torch.linalg.norm(d, dim=-1)
        n = d / (dist[..., None] + 1e-9)
        f = f + _contact_force(cp, radius + r - dist, n, v)

    for cx, cy, top_z, r in w.discs:
        on = torch.linalg.norm(p[..., :2] - device_const([cx, cy], p), dim=-1) < r
        # One-sided: supports only a body whose centre is above the surface.
        above = p[..., 2] > top_z
        f = f + _contact_force(cp, (top_z + radius - p[..., 2]) * on * above, up, v)

    for cx, cy, z_lo, z_hi, r in w.cylinders:
        in_span = (p[..., 2] > z_lo) & (p[..., 2] < z_hi)
        d = p[..., :2] - device_const([cx, cy], p)
        dist = torch.linalg.norm(d, dim=-1)
        n = torch.cat([d / (dist[..., None] + 1e-9), torch.zeros_like(p[..., 2:3])], dim=-1)
        f = f + _contact_force(cp, (radius + r - dist) * in_span, n, v)

    return f


def point_motion(origins: Tensor, axes: Tensor, points: Tensor, qdot: Tensor,
                 base_pos: Tensor, base_vel: Tensor, omega_world: Tensor,
                 n_moving: Tensor) -> Tuple[Tensor, Tensor]:
    """World velocity and position Jacobian of points carried by the arm.

    ``origins``/``axes`` (..., J, 3) are the world joint frames, ``points``
    (..., P, 3) the points and ``n_moving`` (P, J) the 0/1 mask of the
    joints that move each point.  Returns (velocities (..., P, 3),
    Jacobians (..., P, 3, J)) with dp/dq_j = axis_j x (p - origin_j)."""
    lever = points[..., :, None, :] - origins[..., None, :, :]            # (..., P, J, 3)
    cols = torch.linalg.cross(axes[..., None, :, :].expand_as(lever), lever, dim=-1)
    cols = cols * n_moving[..., None]
    vel = (base_vel[..., None, :]
           + torch.linalg.cross(omega_world[..., None, :].expand_as(points),
                                points - base_pos[..., None, :], dim=-1)
           + torch.sum(cols * qdot[..., None, :, None], dim=-2))
    return vel, cols.transpose(-1, -2)


def whole_body_contact(cp: ContactParams, spec: ChainSpec, q: Tensor, qdot: Tensor,
                       base_pos: Tensor, base_quat: Tensor, base_vel: Tensor,
                       omega_body: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Contact forces on the whole robot against the world primitives.

    Returns ``(f_base_body, tau_base_body, tau_arm)``: the total contact
    force (..., 3) and moment about the base origin (..., 3), both in the
    body frame, and the arm-link forces projected through each contact
    point's Jacobian into joint torques (..., 7)."""
    r_wb = rot.quat_to_matrix(base_quat)
    r_t = r_wb.transpose(-1, -2)
    f_w_total = sphere_world_force(cp, base_pos, base_vel, cp.base_radius)
    tau_w_total = torch.zeros_like(f_w_total)  # the hull force acts at the base origin
    tau_arm = torch.zeros_like(q)
    if cp.link_spheres:
        origins, axes, _, _ = chain_mod.joint_frames_posquat(spec, q, base_pos, base_quat)
        idx = [i for i, _ in cp.link_spheres]
        # Joint j moves the child-frame origin of joint i for j < i.
        mask = [[1.0 if j < i else 0.0 for j in range(spec.n_joints)] for i in idx]
        omega_w = (r_wb @ omega_body.unsqueeze(-1)).squeeze(-1)
        # The sphere centres by basic indexing: a list index would copy an
        # index tensor from the host, which a CUDA graph cannot capture.
        points = torch.stack([origins[..., i, :] for i in idx], dim=-2)
        vel, jac = point_motion(origins, axes, points, qdot, base_pos, base_vel, omega_w,
                                device_const(mask, q))
        for s, (_, radius) in enumerate(cp.link_spheres):
            p_i = points[..., s, :]
            f_i = sphere_world_force(cp, p_i, vel[..., s, :], radius)
            f_w_total = f_w_total + f_i
            tau_w_total = tau_w_total + torch.linalg.cross(p_i - base_pos, f_i, dim=-1)
            tau_arm = tau_arm + (jac[..., s, :, :].transpose(-1, -2)
                                 @ f_i.unsqueeze(-1)).squeeze(-1)
    return ((r_t @ f_w_total.unsqueeze(-1)).squeeze(-1),
            (r_t @ tau_w_total.unsqueeze(-1)).squeeze(-1), tau_arm)


def stand_primitives(center_xy: Tuple[float, float], top_z: float, radius: float = 0.25,
                     ground_z: float = 0.0) -> WorldPrimitives:
    """The pick_weight support stand as world geometry: the top disc and
    the column."""
    cx, cy = center_xy
    return WorldPrimitives(ground_z=ground_z, discs=((cx, cy, top_z, radius),),
                           cylinders=((cx, cy, ground_z, top_z, radius),))
