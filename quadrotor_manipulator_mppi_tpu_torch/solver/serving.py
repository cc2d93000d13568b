"""Packed serving API: the minimum-argument whole-body solve call.

Port of the JAX package's ``solver/serving.py`` with the same wire
contract (all float32):

``obs_vec`` (27,): [0:3] base world position, [3:7] base quaternion wxyz
(body->world), [7:14] arm q, [14:17] base world velocity, [17:20] base body
rates, [20:27] arm qdot.

``target_vec`` (10,): [EE position (3), EE quaternion wxyz (4), base
station-keeping target (3)].

``out_vec`` (25,): [action (11), qdes (7), vdes (7)].

The bridge head (:func:`make_bridge_step`) answers instead with
``reply_vec`` (10,): [arm efforts (7), base position carrot (3)].

The carry holds the warm start, the Philox seed and the solve index, all
on the device; sigma is a build-time constant.

On the card each call replays a CUDA graph of one solve
(``utils/graphs.graphed``), the counterpart of the JAX package's
``jax.jit(pstep, donate_argnums=0)``: the graph holds its own static carry,
inputs and output, and advances the solve index in place.  The carry is
donated: a call copies a carry it did not return into its static buffers,
and the carry it returns is those buffers, which the next call overwrites.
The reply vector is the caller's to keep (one small copy after the replay).
``graph=False`` keeps the eager call; on the CPU the call is always eager.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.multirotor import Multirotor12State
from ..models.whole_body import WholeBodyState
from ..utils import rotations as rot
from ..ops.sampling import philox_keys
from ..utils import graphs
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
    seed: Tensor    # (1,) int64 Philox key, on the device
    step: Tensor    # (1,) int64 solve index, on the device


def _init_carry(init, seed, dtype, dev) -> PackedCarry:
    st = init(seed, dtype)
    return PackedCarry(u_prev=st.u_prev, seed=philox_keys(seed, dev).clone(),
                       step=torch.zeros(1, dtype=torch.int64, device=dev))


def _graphed_call(solve, dev):
    """``call(carry, *vecs, z)`` replaying a CUDA graph of ``solve(carry,
    *vecs, z) -> (reply, new carry)`` (``utils.graphs.graphed``: one graph
    per argument structure, so one for calls with ``z`` and one without).
    Returns (a copy of the reply, the static carry)."""

    def fn(carry, *args):
        reply, new = solve(carry, *args)
        graphs.copy_into(carry, new)  # the warm start and the advanced solve index
        return reply

    load = graphs.graphed(fn, dev)

    def call(carry: PackedCarry, *args):
        *vecs, z = args
        if z is not None:
            z = torch.as_tensor(z, dtype=torch.float32)
        g = load(carry, *vecs, z)
        return g.replay().clone(), g.args[0]

    return call


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
    graph: bool = True,
    backend: str = "cuda",
):
    """Build the packed serving solve.

    Returns ``(pstep, pinit)``: ``pinit(seed) -> PackedCarry``; with
    ``static_targets`` (a WholeBodyObs or an (ee_target Pose, base_target)
    pair) ``pstep(carry, obs_vec, z=None) -> (out_vec, carry)``, without it
    ``pstep(carry, obs_vec, target_vec, z=None)``.  ``z`` optionally
    replaces the Philox draw with standard normals (K, H, A).

    On the card (``graph=True``) each call replays a CUDA graph of one
    solve and the carry is donated (see the module docstring): the returned
    carry is overwritten by the next call, so keep a copy of one you need
    later.  ``graph=False`` runs the solve eagerly; so does the CPU.

    ``backend="cuda"`` (the default, the JAX ``"pallas"`` default) solves
    on the hand-written kernels and refuses what they cannot run;
    ``backend="torch"`` (the JAX ``"xla"``) solves on the plain pipeline,
    any configuration (``zero_mean_noise``, a K that is not a multiple of
    16, ...), and is captured and replayed the same way on the card."""
    params = params or wbs.WholeBodyMPPIParams()
    if params.mppi.adaptive_sigma:
        raise ValueError(
            "packed serving folds sigma to a build-time constant; "
            "adaptive_sigma needs the full MPPIState API"
        )
    dev = resolve_device(device)
    step, init = wbs.make_whole_body_solver(params, device=dev, backend=backend,
                                            low_k_guard=low_k_guard)
    sigma_const = _diag_sigma(params.mppi, torch.float32, dev)

    def solve(carry: PackedCarry, obs_vec: Tensor, target_vec: Tensor, z):
        out, new = step(
            MPPIState(u_prev=carry.u_prev, sigma=sigma_const, seed=carry.seed,
                      step=carry.step),
            unpack_obs(obs_vec, target_vec), z,
        )
        out_vec = torch.cat([out.action, out.qdes, out.vdes])
        return out_vec, PackedCarry(u_prev=new.u_prev, seed=new.seed, step=new.step)

    if graph and dev.type == "cuda":
        solve = _graphed_call(solve, dev)

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
        return _init_carry(init, seed, dtype, dev)

    return pstep, pinit


BRIDGE_OUT_SIZE = 10


def make_bridge_step(
    params: Optional["wbs.WholeBodyMPPIParams"] = None,
    setpoint_lookahead: int = 10,
    device="cuda",
    low_k_guard: str = "warn",
    graph: bool = True,
    backend: str = "cuda",
):
    """The whole-body bridge head: the solve, the inertia-weighted tracking
    torque and the smooth-carrot base setpoint in one call.

    ``bstep(carry, obs_vec, target_vec, z=None) -> (reply_vec, carry)`` with
    ``reply_vec`` (10,) = [arm efforts tau (7), base position carrot (3)].
    Position mode only (its base command is a position setpoint).
    ``bpinit(seed) -> PackedCarry``.  On the card each call replays a CUDA
    graph and donates the carry, as :func:`make_packed_step`;
    ``graph=False`` runs eagerly.

    ``backend="cuda"`` (the default) solves on the hand-written kernels;
    ``backend="torch"`` on the plain pipeline, the counterpart of the JAX
    bridge head's default ``"xla"`` (the JAX ``"pallas"`` is ``"cuda"``
    here), for configurations the kernels refuse, such as K=500."""
    from ..models import rigid_body as rb
    from ..models.whole_body import _base_rollout_position

    params = params or wbs.position_mode_params(n_samples=512, n_horizon=50)
    if params.model.control_mode != "position":
        raise ValueError("the bridge head requires the position mode")
    if params.mppi.adaptive_sigma:
        raise ValueError(
            "packed serving folds sigma to a build-time constant; "
            "adaptive_sigma needs the full MPPIState API"
        )
    dev = resolve_device(device)
    step, init = wbs.make_whole_body_solver(params, device=dev, backend=backend,
                                            low_k_guard=low_k_guard)
    sigma_const = _diag_sigma(params.mppi, torch.float32, dev)
    spec = params.model.chain()
    inertials = params.model.inertials()
    lookahead = min(setpoint_lookahead, params.mppi.n_horizon - 1)

    def bstep(carry: PackedCarry, obs_vec: Tensor, target_vec: Tensor, z=None):
        obs = unpack_obs(obs_vec, target_vec)
        out, new = step(MPPIState(u_prev=carry.u_prev, sigma=sigma_const, seed=carry.seed,
                                  step=carry.step), obs, z)
        q, qdot = obs.state.q, obs.state.qdot
        base_rot = rot.quat_to_matrix(rot.quat_normalize(obs_vec[3:7]))
        m = rb.mass_matrix(spec, inertials, q)
        nle = rb.nonlinear_effects(spec, inertials, q, qdot, base_rot=base_rot)
        tau = m @ (400.0 * (out.qdes - q) - 40.0 * qdot) + nle
        # Smooth carrot: the plan's predicted position a short lookahead on.
        pred = _base_rollout_position(params.model, obs.state, out.u_seq[None, :, :4],
                                      params.mppi.dt)
        reply = torch.cat([tau, pred.pos[0, lookahead]])
        return reply, PackedCarry(u_prev=new.u_prev, seed=new.seed, step=new.step)

    if graph and dev.type == "cuda":
        call = _graphed_call(bstep, dev)

        def bstep(carry: PackedCarry, obs_vec: Tensor, target_vec: Tensor, z=None):
            return call(carry, obs_vec, target_vec, z)

    def bpinit(seed: int, dtype=torch.float32) -> PackedCarry:
        return _init_carry(init, seed, dtype, dev)

    return bstep, bpinit
