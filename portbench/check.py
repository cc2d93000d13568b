"""The comparison that decides ``correct``.

Run once the window has closed, the peak memory has been read and the
program's state is freed.  The reference (``reference/solve.py``, float64)
recomputes what the timed path produced and each number compared is the
widest gap between the two:

* requests (``packed``, ``batched``): for each sampled (request, vehicle)
  the reply and the warm start the request left in the carry, worked out
  from the warm start, Philox key and solve index the request found in the
  carry.  The first request of a run starts from the reference's own
  initial warm start.  ``plan_gap``: the widest gap of the action (11) and
  the next warm start (H x 11), each channel over its sigma;
  ``setpoint_gap``: the widest gap of the arm setpoints qdes and vdes (rad,
  rad/s).
* episodes: each episode runs as ``calls_per_episode`` calls, each from
  the carry the previous call returned.  For the sampled vehicles, the first
  ``check.steps`` control steps of every call: the first call's from the
  episode's seeded start, each later call's from the program's own state
  that the call started from (plant and warm start), at the solve index
  the reference works out itself.  ``pos_gap_median_m``: the median over
  the sampled (call, vehicle) pairs of each one's widest gap of the base
  position and the three end-effector errors (m), steady where a near tie
  of the softmin flips a few vehicles' plans; ``pos_gap_m``: the widest
  position gap of all, whose limit lies above those flips and catches a
  grossly wrong answer.  The same median of the tilt and the EE orientation
  error is logged, not compared: float32 rounding of the orientation error
  near zero sets it, and the TF32 control reads no higher than the program.

A number with no limit in ``limits/<workload>.json`` fails the run; the
file's ``control`` names the stand-in (``--stand-in``) whose readings the
upper ends of the limits came from.
"""

from __future__ import annotations

import numpy as np
import torch

from .inputs import split_flat
from .reference import solve as ref_solve


def request_numbers(ref: "ref_solve.Reference", driver: str, records: list) -> dict:
    """The gaps over ``records``: dicts with ``key``, ``step``, ``x`` (the
    vehicle's request row), ``u_before`` (None: the first request),
    ``reply`` (25,) and ``u_after`` (H, A)."""
    sigma = ref.sigma.double().cpu().numpy()
    plan, setpoint = 0.0, 0.0
    for r in records:
        u0 = ref.initial_warm_start() if r["u_before"] is None else r["u_before"]
        if driver == "packed":
            reply, u_after = ref.solve_packed(u0, r["key"], r["step"], r["x"])
        else:
            reply, u_after = ref.solve_fields(u0, r["key"], r["step"], split_flat(r["x"]))
        reply, u_after = reply.double().cpu().numpy(), u_after.double().cpu().numpy()
        got_reply = np.asarray(r["reply"], dtype=np.float64)
        got_u = np.asarray(r["u_after"], dtype=np.float64)
        plan = max(plan, float(np.max(np.abs(got_reply[:11] - reply[:11]) / sigma)),
                   float(np.max(np.abs(got_u - u_after) / sigma)))
        setpoint = max(setpoint, float(np.max(np.abs(got_reply[11:] - reply[11:]))))
    return {"plan_gap": plan, "setpoint_gap": setpoint}


POS_LOGS = ("base_pos", "ee_err", "l1_cmd", "l1_meas")
ANGLE_LOGS = ("tilt", "ori_err")


def episode_numbers(ref: "ref_solve.Reference", loop: dict, steps: int, records: list) -> dict:
    """The gaps over ``records``: dicts with ``start`` (the sampled vehicles'
    rows of an episode start: targets and keys), ``carry`` (None: the
    episode's first call, from the start; else the program's state rows
    that the call started from), ``step0`` (the call's first solve index)
    and ``logs`` (the sampled vehicles' log rows, the call's first
    ``steps`` control steps)."""
    pos, ang, pos_v, ang_v = np.zeros(steps), np.zeros(steps), [], []
    for r in records:
        want, _ = ref.episode(r["start"], loop, steps, r["carry"], r["step0"])
        vp = va = 0.0
        for f in POS_LOGS + ANGLE_LOGS:
            d = np.abs(np.asarray(r["logs"][f], dtype=np.float64)[:, :steps] - want[f][:, :steps])
            d = np.nan_to_num(d.reshape(d.shape[0], steps, -1), nan=np.inf)
            if f in POS_LOGS:
                pos = np.maximum(pos, d.max(axis=(0, 2)))
                vp = np.maximum(vp, d.max(axis=(1, 2)))
            else:
                ang = np.maximum(ang, d.max(axis=(0, 2)))
                va = np.maximum(va, d.max(axis=(1, 2)))
        pos_v.extend(np.atleast_1d(vp))
        ang_v.extend(np.atleast_1d(va))
    from .core import log

    log("episode gaps by step: pos_m " + " ".join(f"{x:.2e}" for x in pos)
        + " | angle_rad (not compared) " + " ".join(f"{x:.2e}" for x in ang)
        + f" | median vehicle's angle gap (not compared) {np.median(ang_v):.3e} rad")
    return {"pos_gap_m": float(pos.max()), "pos_gap_median_m": float(np.median(pos_v))}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and a limit for every number."""
    shown, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        shown[name] = {"value": value, "limit": limit}
        if limit is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, shown


def free_device() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
