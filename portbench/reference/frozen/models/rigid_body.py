"""Articulated rigid-body dynamics of a serial chain.

Port of the JAX package's ``models/rigid_body.py``: a recursive
Newton-Euler pass (RNEA) in link-local coordinates, unrolled over the joints
and batched over any leading dims; the mass matrix by the unit-acceleration
method; forward dynamics through a Cholesky factor; and the frozen
(gravity-linear, velocity-quadratic) coefficients the 1 kHz plant substeps
contract against, all from one batched RNEA.

The 7x7 factorizations use ``torch.linalg.cholesky_ex``: unlike
``cholesky``/``inv``/``solve`` it does not make the host wait for the card
to check for errors.  The solves with the factor are two triangular solves
(``torch.linalg.solve_triangular``, cuBLAS on the card) for one matrix and
for a batch alike: PyTorch takes MAGMA's batched Cholesky solve for
``cholesky_inverse`` and ``cholesky_solve`` on a batch, which a CUDA graph
cannot capture, and one path keeps a fleet's vehicle bit-equal to the same
vehicle alone.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import device_const
from .chain import REVOLUTE, ChainSpec, joint_rotation_terms

Tensor = torch.Tensor

GRAVITY = 9.81


@dataclass(frozen=True)
class InertialParams:
    """Host-side per-link inertial constants in the child-link frame:
    mass (J,), centre of mass (J, 3), rotational inertia about the centre
    of mass (J, 3, 3), as URDF ``<inertial>`` blocks give them."""

    mass: np.ndarray
    com: np.ndarray
    inertia: np.ndarray


class SpatialVel(NamedTuple):
    """Angular + linear velocity (or acceleration) of a frame, local coords."""

    ang: Tensor
    lin: Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _mv(m: Tensor, v: Tensor) -> Tensor:
    """Matrix [..., 3, 3] times vector [..., 3]."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def rnea(
    spec: ChainSpec,
    params: InertialParams,
    q: Tensor,
    qd: Tensor,
    qdd: Tensor,
    gravity: float = GRAVITY,
    base_rot: Optional[Tensor] = None,
    base_vel: Optional[SpatialVel] = None,
    base_acc: Optional[SpatialVel] = None,
) -> Tuple[Tensor, SpatialVel]:
    """Inverse dynamics: joint torques realizing ``qdd`` at ``(q, qd)``.

    Returns ``(tau [..., J], base reaction wrench)``, the wrench being what
    the chain exerts on its mount, in the base frame.  ``base_rot`` is the
    body->world rotation [..., 3, 3]; gravity enters as the fictitious base
    acceleration a0 = R^T (0, 0, +g).  ``base_vel``/``base_acc`` couple in
    floating-base motion."""
    batch = q.shape[:-1]
    zero3 = torch.zeros(batch + (3,), dtype=q.dtype, device=q.device)
    if base_rot is None:
        a0_lin = zero3 + device_const([0.0, 0.0, gravity], q)
    else:
        a0_lin = (gravity * base_rot[..., 2, :]).expand(batch + (3,))
    w = zero3 if base_vel is None else base_vel.ang
    dw =zero3 if base_acc is None else base_acc.ang
    a = a0_lin if base_acc is None else base_acc.lin + a0_lin

    rs, ps, axes, f_links, n_links, coms = [], [], [], [], [], []
    for j in range(spec.n_joints):
        axis = device_const(spec.axis[j], q)
        p = device_const(spec.origin_trans[j], q)
        if int(spec.joint_type[j]) == REVOLUTE:
            oa, ob, oc = joint_rotation_terms(spec, j)
            c = torch.cos(q[..., j])[..., None, None]
            s = torch.sin(q[..., j])[..., None, None]
            r = c * device_const(oa, q) + s * device_const(ob, q) + device_const(oc, q)
        else:
            r = device_const(spec.origin_rot[j], q).expand(batch + (3, 3))
            p = p + device_const(spec.origin_rot[j] @ spec.axis[j], q) * q[..., j:j + 1]
        rt = r.transpose(-1, -2)
        qd_j = qd[..., j:j + 1] * axis
        qdd_j = qdd[..., j:j + 1] * axis
        a_in = _mv(rt, a + _cross(dw, p) + _cross(w, _cross(w, p)))
        rw = _mv(rt, w)
        if int(spec.joint_type[j]) == REVOLUTE:
            w_c = rw + qd_j
            dw_c = _mv(rt, dw) + qdd_j + _cross(rw, qd_j)
            a_c = a_in
        else:
            w_c = rw
            dw_c = _mv(rt, dw)
            a_c = a_in + qdd_j + 2.0 * _cross(w_c, qd_j)
        w, dw, a = w_c, dw_c, a_c
        rs.append(r)
        ps.append(p)
        axes.append(axis)

        c_j = device_const(params.com[j], q)
        i_j = device_const(params.inertia[j], q)
        a_com = a + _cross(dw, c_j) + _cross(w, _cross(w, c_j))
        f_links.append(float(params.mass[j]) * a_com)
        n_links.append(_mv(i_j, dw) + _cross(w, _mv(i_j, w)))
        coms.append(c_j)

    f_child, n_child = zero3, zero3
    taus = [None] * spec.n_joints
    for j in reversed(range(spec.n_joints)):
        f_j = f_links[j] + f_child
        n_j = n_links[j] + _cross(coms[j], f_links[j]) + n_child
        taus[j] = ((n_j if int(spec.joint_type[j]) == REVOLUTE else f_j) * axes[j]).sum(-1)
        f_parent = _mv(rs[j], f_j)
        n_child = _mv(rs[j], n_j) + _cross(ps[j], f_parent)
        f_child = f_parent
    return torch.stack(taus, dim=-1), SpatialVel(ang=n_child, lin=f_child)


def gravity_torque(spec: ChainSpec, params: InertialParams, q: Tensor,
                   base_rot: Optional[Tensor] = None) -> Tensor:
    """g(q): torques holding the arm static under gravity."""
    z = torch.zeros_like(q)
    return rnea(spec, params, q, z, z, base_rot=base_rot)[0]


def nonlinear_effects(spec: ChainSpec, params: InertialParams, q: Tensor, qd: Tensor,
                      base_rot: Optional[Tensor] = None) -> Tensor:
    """C(q, qd) qd + g(q), Pinocchio's ``nle``."""
    return rnea(spec, params, q, qd, torch.zeros_like(q), base_rot=base_rot)[0]


def mass_matrix(spec: ChainSpec, params: InertialParams, q: Tensor) -> Tensor:
    """M(q) [..., J, J] by the unit-acceleration method: column c is
    RNEA(q, 0, e_c) with gravity off, all columns in one batched pass."""
    j_n = spec.n_joints
    qb = q.unsqueeze(-2).expand(q.shape[:-1] + (j_n, j_n))
    eye = torch.eye(j_n, dtype=q.dtype, device=q.device).expand_as(qb)
    tau, _ = rnea(spec, params, qb, torch.zeros_like(qb), eye, gravity=0.0)
    return tau.transpose(-1, -2)


def forward_dynamics(spec: ChainSpec, params: InertialParams, q: Tensor, qd: Tensor,
                     tau: Tensor, base_rot: Optional[Tensor] = None) -> Tensor:
    """qdd = M(q)^-1 (tau - nle(q, qd)), through a Cholesky factor of M."""
    chol = torch.linalg.cholesky_ex(mass_matrix(spec, params, q)).L
    return forward_dynamics_chol(spec, params, q, qd, tau, chol, base_rot=base_rot)


class FrozenArmCoeffs(NamedTuple):
    """Per-configuration dynamics coefficients for the 1 kHz substeps.

    At a fixed q (and zero base spatial motion) the RNEA torque is exactly
    ``tau = G_tau a0 + qd^T C_tau qd`` with a0 = R_base^T (0, 0, +g); the
    root reaction wrench decomposes the same way.  Freezing q over one
    control period turns each substep's arm dynamics into three
    contractions; all coefficients come from one batched RNEA."""

    g_tau: Tensor   # (J, 3)    gravity torque = g_tau @ a0
    c_tau: Tensor   # (J, J, J) Coriolis/centrifugal tensor (torques)
    g_n: Tensor     # (3, 3)    root reaction moment (gravity part)
    c_n: Tensor     # (3, J, J) root moment, velocity part
    g_f: Tensor     # (3, 3)    root reaction force (gravity part)
    c_f: Tensor     # (3, J, J)
    mass: Tensor    # (J, J)    M(q)
    chol: Tensor    # (J, J)    cholesky(M)
    minv: Tensor    # (J, J)    M(q)^-1


@functools.lru_cache(maxsize=None)
def _probe_basis(j_n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(qd, qdd, a0) of the J^2 velocity pairs, J singles, 3 gravity
    directions and J mass-matrix columns (J^2 + 2J + 3 probes)."""
    eye = np.eye(j_n)
    pair_qd = (eye[:, None, :] + eye[None, :, :]).reshape(j_n * j_n, j_n)
    n_vel = j_n * j_n + j_n
    qd = np.concatenate([pair_qd, eye, np.zeros((3 + j_n, j_n))])
    qdd = np.concatenate([np.zeros((n_vel + 3, j_n)), eye])
    a0 = np.concatenate([np.zeros((n_vel, 3)), np.eye(3), np.zeros((j_n, 3))])
    return qd, qdd, a0


def frozen_arm_coeffs(spec: ChainSpec, params: InertialParams, q: Tensor) -> FrozenArmCoeffs:
    """The exact (gravity-linear, velocity-quadratic) coefficients of the
    chain dynamics at ``q`` [..., J] from one batched RNEA over
    J^2 + 2J + 3 probes.  The quadratic part comes by polarization: with
    h(qd) = rnea(q, qd, 0, gravity=0), C[:, j, k] = (h(e_j + e_k) - h(e_j)
    - h(e_k)) / 2."""
    j_n = spec.n_joints
    qd_np, qdd_np, a0_np = _probe_basis(j_n)
    n_probe = qd_np.shape[0]
    qb = q.unsqueeze(-2).expand(q.shape[:-1] + (n_probe, j_n))
    zeros3 = torch.zeros(qb.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    tau_b, wrench = rnea(
        spec, params, qb, device_const(qd_np, q).expand_as(qb),
        device_const(qdd_np, q).expand_as(qb), gravity=0.0,
        base_acc=SpatialVel(ang=zeros3, lin=zeros3 + device_const(a0_np, q)),
    )
    n_b, f_b = wrench.ang, wrench.lin
    n_pair, n_vel = j_n * j_n, j_n * j_n + j_n

    def polarize(out):
        pair = out[..., :n_pair, :].unflatten(-2, (j_n, j_n))     # (..., J, J, dim)
        single = out[..., n_pair:n_vel, :]                        # (..., J, dim)
        c = 0.5 * (pair - single.unsqueeze(-2) - single.unsqueeze(-3))
        return c.movedim(-1, -3)                                  # (..., dim, J, J)

    def grav(out):
        return out[..., n_vel:n_vel + 3, :].transpose(-1, -2)

    mass = tau_b[..., n_vel + 3:, :].transpose(-1, -2)
    chol = torch.linalg.cholesky_ex(mass).L
    return FrozenArmCoeffs(
        g_tau=grav(tau_b), c_tau=polarize(tau_b), g_n=grav(n_b), c_n=polarize(n_b),
        g_f=grav(f_b), c_f=polarize(f_b), mass=mass, chol=chol,
        minv=_spd_inverse(chol),
    )


def _chol_solve(chol: Tensor, rhs: Tensor) -> Tensor:
    """M^-1 rhs from the lower Cholesky factor of M, by two triangular
    solves (see the module docstring)."""
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)


def _spd_inverse(chol: Tensor) -> Tensor:
    """M^-1 from the lower Cholesky factor of M (batched over leading
    dims)."""
    linv = torch.linalg.solve_triangular(
        chol, torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device).expand_as(chol),
        upper=False)
    return linv.transpose(-1, -2) @ linv


def gravity_accel(base_rot: Optional[Tensor], dtype=torch.float32,
                  gravity: float = GRAVITY, device=None) -> Tensor:
    """The fictitious base acceleration a0 = R^T (0, 0, +g) that the frozen
    coefficients contract against."""
    if base_rot is None:
        return torch.tensor([0.0, 0.0, gravity], dtype=dtype, device=device)
    return (gravity * base_rot[..., 2, :]).to(dtype)


def frozen_nle(co: FrozenArmCoeffs, a0: Tensor, qd: Tensor) -> Tensor:
    """C(q, qd) qd + g(q) from frozen coefficients."""
    return (torch.einsum("...ij,...j->...i", co.g_tau, a0)
            + torch.einsum("...ijk,...j,...k->...i", co.c_tau, qd, qd))


def frozen_forward_dynamics(co: FrozenArmCoeffs, a0: Tensor, qd: Tensor, tau: Tensor) -> Tensor:
    """qdd = M^-1 (tau - nle) with every q-dependent quantity frozen."""
    return torch.einsum("...ij,...j->...i", co.minv, tau - frozen_nle(co, a0, qd))


def frozen_gravity_torque_on_base(co: FrozenArmCoeffs, a0: Tensor) -> Tensor:
    """Arm gravity moment on the base (base frame) from frozen coefficients:
    minus the root moment the mount must apply."""
    return -torch.einsum("...ij,...j->...i", co.g_n, a0)


def forward_dynamics_chol(spec: ChainSpec, params: InertialParams, q: Tensor, qd: Tensor,
                          tau: Tensor, chol: Tensor,
                          base_rot: Optional[Tensor] = None) -> Tensor:
    """Forward dynamics with a caller-supplied Cholesky factor of M (a
    factor taken once per control period and reused by its substeps)."""
    rhs = (tau - nonlinear_effects(spec, params, q, qd, base_rot=base_rot)).unsqueeze(-1)
    return _chol_solve(chol, rhs).squeeze(-1)
