"""Packed serving API: the minimum-argument whole-body solve call.

Port of the JAX package's ``solver/serving.py`` with the same wire
contract (all float32):

``obs_vec`` (27,): [0:3] base world position, [3:7] base quaternion wxyz
(body->world), [7:14] arm q, [14:17] base world velocity, [17:20] base body
rates, [20:27] arm qdot.

``target_vec`` (10,): [EE position (3), EE quaternion wxyz (4), base
station-keeping target (3)].

``out_vec`` (25,): [action (11), qdes (7), vdes (7)].

The carry holds the warm start on the device and the Philox seed and solve
index on the host; sigma is a build-time constant.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.multirotor import Multirotor12State
from ..models.whole_body import WholeBodyState
from ..utils import rotations as rot
from ..utils.device import resolve_device
from ..utils.pose import Pose
from . import whole_body as wbs
from .mppi import MPPIState, _diag_sigma

Tensor = torch.Tensor

OBS_SIZE = 27
TARGET_SIZE = 10
OUT_SIZE = 25


class PackedCarry(NamedTuple):
    u_prev: Tensor  # (H, A), on the device
    seed: int       # Philox key
    step: int       # solve index


def pack_obs(obs: "wbs.WholeBodyObs") -> Tuple[Tensor, Tensor]:
    """WholeBodyObs -> (obs_vec (27,), target_vec (10,)); the base attitude
    goes on the wire as a quaternion."""
    st = obs.state
    quat = rot.matrix_to_quat(rot.euler_to_matrix(
        torch.stack([st.base.rpy[2], st.base.rpy[1], st.base.rpy[0]]), "ZYX"
    ))
    obs_vec = torch.cat([st.base.pos, quat, st.q, st.base.vel, st.base.omega,
                         st.qdot]).to(torch.float32)
    target_vec = torch.cat([obs.ee_target.position, obs.ee_target.quat,
                            obs.base_target]).to(torch.float32)
    return obs_vec, target_vec


def unpack_obs(obs_vec: Tensor, target_vec: Tensor) -> "wbs.WholeBodyObs":
    """(obs_vec, target_vec) -> WholeBodyObs, on the vectors' device."""
    quat = rot.quat_normalize(obs_vec[3:7])
    ang = rot.matrix_to_euler(rot.quat_to_matrix(quat), "ZYX")
    base = Multirotor12State(
        pos=obs_vec[0:3], rpy=torch.stack([ang[2], ang[1], ang[0]]),
        vel=obs_vec[14:17], omega=obs_vec[17:20],
    )
    return wbs.WholeBodyObs(
        state=WholeBodyState(base=base, q=obs_vec[7:14], qdot=obs_vec[20:27]),
        ee_target=Pose(position=target_vec[0:3],
                       quat=rot.quat_normalize(target_vec[3:7])),
        base_target=target_vec[7:10],
    )


def unpack_out(out_vec: Tensor) -> "wbs.WholeBodyOutput":
    """out_vec (25,) -> WholeBodyOutput (without the plan u_seq, which stays
    in the carry)."""
    return wbs.WholeBodyOutput(action=out_vec[0:11], u_seq=None,
                               qdes=out_vec[11:18], vdes=out_vec[18:25])


def make_packed_step(
    params: Optional["wbs.WholeBodyMPPIParams"] = None,
    device="cuda",
    static_targets=None,
    low_k_guard: str = "warn",
):
    """Build the packed serving solve on the CUDA kernels.

    Returns ``(pstep, pinit)``: ``pinit(seed) -> PackedCarry``; with
    ``static_targets`` (a WholeBodyObs or an (ee_target Pose, base_target)
    pair) ``pstep(carry, obs_vec, z=None) -> (out_vec, carry)``, without it
    ``pstep(carry, obs_vec, target_vec, z=None)``.  ``z`` optionally
    replaces the Philox draw with standard normals (K, H, A)."""
    params = params or wbs.WholeBodyMPPIParams()
    if params.mppi.adaptive_sigma:
        raise ValueError(
            "packed serving folds sigma to a build-time constant; "
            "adaptive_sigma needs the full MPPIState API"
        )
    dev = resolve_device(device)
    step, init = wbs.make_whole_body_solver(params, device=dev, low_k_guard=low_k_guard)
    sigma_const = _diag_sigma(params.mppi, torch.float32, dev)

    def solve(carry: PackedCarry, obs_vec: Tensor, target_vec: Tensor, z):
        out, new = step(
            MPPIState(u_prev=carry.u_prev, sigma=sigma_const, seed=carry.seed,
                      step=carry.step),
            unpack_obs(obs_vec, target_vec), z,
        )
        out_vec = torch.cat([out.action, out.qdes, out.vdes])
        return out_vec, PackedCarry(u_prev=new.u_prev, seed=new.seed, step=new.step)

    if static_targets is not None:
        if isinstance(static_targets, wbs.WholeBodyObs):
            ee_t, base_t = static_targets.ee_target, static_targets.base_target
        else:
            ee_t, base_t = static_targets
        target_const = torch.cat([ee_t.position, ee_t.quat, base_t]).to(
            device=dev, dtype=torch.float32)

        def pstep(carry: PackedCarry, obs_vec: Tensor, z=None):
            return solve(carry, obs_vec, target_const, z)
    else:

        def pstep(carry: PackedCarry, obs_vec: Tensor, target_vec: Tensor, z=None):
            return solve(carry, obs_vec, target_vec, z)

    def pinit(seed: int, dtype=torch.float32) -> PackedCarry:
        st = init(seed, dtype)
        return PackedCarry(u_prev=st.u_prev, seed=st.seed, step=st.step)

    return pstep, pinit
