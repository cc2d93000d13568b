"""Scenario registry: each command-line name -> the port's keyword runner,
and the one table that turns ``run.py``'s parsed arguments into that
runner's keyword arguments.  Runners resolve lazily, so importing the
command line stays cheap (each scenario imports its own stack on first
use).  The names are the JAX package's.
"""

from __future__ import annotations

import importlib


def _common(a) -> dict:
    return {"seed": a.seed, "steps": a.steps}


def _k(a) -> dict:
    return {"n_samples": a.k or None}


# name -> (module, runner, the runner's keyword arguments from the parsed
# command line; the device, the log dict and the checkpoint paths are
# added by run.py).
_REGISTRY = {
    "arm-reach": ("solvers", "run_arm_reach", _common),
    "bench-scaling": ("scaling", "run_bench_scaling",
                      lambda a: {"devices": a.devices, "k_per_device": a.k_per_device,
                                 "iters": a.iters}),
    "camera-survey": ("rotorcraft", "run_camera_survey",
                      lambda a: {**_common(a), "out_dir": a.out_dir, "stream": a.stream}),
    "disturbance": ("rotorcraft", "run_disturbance", _common),
    "drone-waypoint": ("solvers", "run_drone_waypoint",
                       lambda a: {**_common(a), "controller": a.controller}),
    "figure-eight": ("rotorcraft", "run_figure_eight",
                     lambda a: {**_common(a), "vehicle": a.vehicle, "period": a.period}),
    "fixed-wing": ("solvers", "run_fixed_wing", lambda a: {**_common(a), **_k(a)}),
    "hover": ("rotorcraft", "run_hover",
              lambda a: {**_common(a), "vehicle": a.vehicle, "controller": a.controller}),
    "mapped-flight": ("solvers", "run_mapped_flight",
                      lambda a: {**_common(a), **_k(a), "obstacles": a.obstacles}),
    "mission": ("rotorcraft", "run_mission", _common),
    "multirotor-waypoint": ("solvers", "run_multirotor_waypoint", _common),
    "pick-weight": ("whole_body", "run_pick_weight", _common),
    "waypoint-file": ("rotorcraft", "run_waypoint_file",
                      lambda a: {**_common(a), "path": a.file, "smooth": a.smooth,
                                 "vehicle": a.vehicle}),
    "whole-body": ("solvers", "run_whole_body", _common),
    "whole-body-batch": ("whole_body", "run_whole_body_batch",
                         lambda a: {**_common(a), "n_scenarios": a.scenarios,
                                    "n_samples": a.k_per_device, "hold": a.hold}),
    "whole-body-full": ("whole_body", "run_whole_body_full",
                        lambda a: {**_common(a), **_k(a), "mode": a.mode}),
}

NAMES = sorted(_REGISTRY)


def get(name: str):
    """The keyword runner of scenario ``name``."""
    mod_name, fn_name, _ = _REGISTRY[name]
    mod = importlib.import_module(f".{mod_name}", __package__)
    return getattr(mod, fn_name)


def kwargs(name: str, args) -> dict:
    """Scenario ``name``'s runner arguments from the parsed command line."""
    return _REGISTRY[name][2](args)
