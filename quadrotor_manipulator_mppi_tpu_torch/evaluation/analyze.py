"""Log analysis: the ``rotors_evaluation`` metric families over a log.

Port of the JAX package's ``evaluation/analyze.py``: the hover, waypoint
and disturbance-recovery summaries of a log ``data`` (a mapping with
``"pos"`` (T, 3) and, for hover, optionally ``"omega"``), as tensors on any
device or NumPy arrays.  Its command line reads a scenario's ``--save-log``
file and prints one JSON line:

    python -m quadrotor_manipulator_mppi_tpu_torch.evaluation.analyze \
        waypoint log.npz --target 1 2 3.4 --radius 0.5
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import metrics


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; a NumPy array as a float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32))


def analyze_hover(data, target, dt) -> dict:
    pos = _tensor(data["pos"])
    rate = _tensor(data["omega"]) if "omega" in data else torch.zeros_like(pos)
    m = metrics.hover_metrics(pos, rate, _tensor(target).to(pos.device), dt=dt)
    return {
        "pos_rms_m": round(float(m.pos_rms), 4),
        "ang_rate_rms": round(float(m.ang_rate_rms), 4),
        "settling_time_s": round(float(m.settling_time), 2),
        "passed": bool(m.passed),
    }


def analyze_waypoint(data, target, dt, radius) -> dict:
    pos = _tensor(data["pos"])
    t_resp = metrics.waypoint_response(pos, _tensor(target).to(pos.device), dt=dt, radius=radius)
    err = np.linalg.norm(pos.cpu().numpy() - np.asarray(target), axis=-1)
    return {
        "response_time_s": round(float(t_resp), 2),
        "min_err_m": round(float(err.min()), 4),
        "final_err_m": round(float(err[-1]), 4),
    }


def analyze_disturbance(data, target, dt, radius) -> dict:
    """Recovery time: the settling time after the peak excursion (the last
    time the error leaves the radius, counted from the peak)."""
    pos = np.asarray(_tensor(data["pos"]).cpu().numpy())
    err = np.linalg.norm(pos - np.asarray(target), axis=-1)
    peak_idx = int(err.argmax())
    st = metrics.settling_time(torch.as_tensor(pos[peak_idx:]),
                               torch.as_tensor(np.asarray(target, np.float32)), dt=dt,
                               radius=radius)
    return {
        "peak_err_m": round(float(err.max()), 4),
        "peak_time_s": round(peak_idx * dt, 2),
        "recovery_time_s": round(float(st), 2),
        "final_err_m": round(float(err[-1]), 4),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="quadrotor_manipulator_mppi_tpu_torch.evaluation.analyze")
    p.add_argument("kind", choices=["hover", "waypoint", "disturbance"])
    p.add_argument("log")
    p.add_argument("--target", type=float, nargs=3, required=True)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--radius", type=float, default=0.1)
    args = p.parse_args(argv)

    with np.load(args.log) as f:
        data = dict(f)
    if args.kind == "hover":
        out = analyze_hover(data, args.target, args.dt)
    elif args.kind == "waypoint":
        out = analyze_waypoint(data, args.target, args.dt, args.radius)
    else:
        out = analyze_disturbance(data, args.target, args.dt, args.radius)
    out = {"kind": args.kind, "log": args.log, **out}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
