"""Scenario runner command line: one command runs a whole closed loop and
prints its metrics as one JSON line.

    python -m quadrotor_manipulator_mppi_tpu_torch.run drone-waypoint
    python -m quadrotor_manipulator_mppi_tpu_torch.run camera-survey --steps 400 --out-dir frames
    python -m quadrotor_manipulator_mppi_tpu_torch.run whole-body-full --steps 200
    python -m quadrotor_manipulator_mppi_tpu_torch.run hover --controller lee --platform cpu

Port of the JAX package's ``run.py``, with its arguments.  Scenarios run
on the card (``--platform auto``); without one the command exits with a
message, and ``--platform cpu`` runs any scenario eagerly on the CPU (the
kernels' plain versions).  ``--save-log``, ``--save-state`` and
``--resume`` behave uniformly through ``scenarios/common.py``; a scenario
whose runner has no log or checkpoint refuses them.
"""

from __future__ import annotations

import argparse
import inspect

from . import scenarios


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="quadrotor_manipulator_mppi_tpu_torch.run")
    p.add_argument("scenario", choices=scenarios.NAMES)
    p.add_argument("--steps", type=int, default=1000, help="control steps (100 Hz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--controller", default="backstepping",
                   choices=["pid", "backstepping", "lee"])
    p.add_argument("--mode", default="position", choices=["position", "attitude", "wrench"],
                   help="whole-body-full action mode")
    p.add_argument("--save-log", default=None, dest="save_log",
                   help="write the scenario's log arrays to this .npz")
    p.add_argument("--vehicle", default="harrier",
                   help="hover: stock vehicle preset (models/vehicles.py)")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: the card (none present is an error); cpu: run eagerly on "
                        "the CPU")
    p.add_argument("--devices", type=int, default=8,
                   help="bench-scaling: ranks (clamped to the cards present)")
    p.add_argument("--k-per-device", type=int, default=2048, dest="k_per_device")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--period", type=float, default=6.0, help="figure-eight lap period [s]")
    p.add_argument("--scenarios", type=int, default=32,
                   help="whole-body-batch: batched episode count")
    p.add_argument("--hold", type=float, default=0.99,
                   help="whole-body-batch: held-fraction gate: a scenario passes only if it "
                        "holds the 5 mm reach gate for this fraction of steps after first "
                        "reaching it")
    p.add_argument("--k", type=int, default=0,
                   help="fixed-wing/mapped-flight/whole-body-full: sample count override "
                        "(0 = preset)")
    p.add_argument("--file", default=None, help="waypoint-file: RotorS-format waypoint file")
    p.add_argument("--smooth", action="store_true",
                   help="waypoint-file: fly a C2 cubic spline through the waypoints (velocity "
                        "and acceleration feed-forward) instead of step setpoints")
    p.add_argument("--out-dir", default=None, dest="out_dir",
                   help="camera-survey: geotagged-frame artifact directory")
    p.add_argument("--stream", default=None,
                   help="camera-survey: push captured frames to a live QMM server "
                        "(HOST:PORT) as IMAGE frames")
    p.add_argument("--save-state", default=None, dest="save_state",
                   help="checkpoint the final episode state (plant and solver, the Philox "
                        "keys included) to this .npz")
    p.add_argument("--resume", default=None,
                   help="resume from a --save-state checkpoint: the episode continues where "
                        "the saved one stopped, on the noise stream the uninterrupted run "
                        "would have drawn")
    p.add_argument("--obstacles", default="spheres", choices=["spheres", "esdf"],
                   help="mapped-flight: obstacle representation (top-N sphere export or the "
                        "occupancy distance field)")
    return p


def device_of(platform: str) -> str:
    """``auto`` -> the card, which must exist; ``cpu`` -> the CPU."""
    import torch

    if platform == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: pass --platform cpu to run the "
                         "scenario on the CPU")
    return "cuda"


def main(argv=None) -> dict:
    """Parse ``argv``, run the scenario, print its JSON line; returns the
    printed object."""
    import torch

    from .scenarios.common import finish

    args = parser().parse_args(argv)
    device = device_of(args.platform)
    runner = scenarios.get(args.scenario)
    kw = scenarios.kwargs(args.scenario, args)
    accepts = inspect.signature(runner).parameters
    logs = {}
    for opt, key, value in (("--save-log", "logs", logs if args.save_log else None),
                            ("--save-state", "save_state", args.save_state),
                            ("--resume", "resume", args.resume)):
        if value is None:
            continue
        if key not in accepts:
            raise SystemExit(f"{args.scenario} does not take {opt}")
        kw[key] = value
    metrics = runner(device=device, **kw)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    return finish(args.scenario, {**metrics, "device": name}, logs, args.save_log)


if __name__ == "__main__":
    main()
