"""Shared scenario plumbing: the hover start of the rotorcraft scenarios
and the perfect-model MPC loop.

Port of the JAX package's ``scenarios/common.py`` (its command-line
report and file options are not ported: the port's scenarios return
their metrics).  Where the JAX package scans an episode, the port runs it
through ``utils/graphs.episode_runner``: on the card one captured control
step replayed per step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models import multirotor as mr
from ..solver.mppi import device_counters
from ..utils import graphs
from ..utils.device import resolve_device


def hover_plant(veh: mr.MultirotorParams, pos, dtype=torch.float32,
                device="cuda") -> mr.MultirotorState:
    """The plant at rest at ``pos`` with the rotors at hover speed: the
    standing start of every rotorcraft scenario."""
    dev = resolve_device(device)
    plant = mr.init_state(veh, pos=pos, dtype=dtype, device=dev)
    return plant._replace(rotor_speed=torch.full((veh.n_rotors,), veh.hover_rotor_speed(),
                                                 dtype=dtype, device=dev))


def perfect_model_episode(step: Callable, obs_of: Callable, plant_step: Callable,
                          log_of: Callable, n_steps: int, device="cuda", graph: bool = True,
                          label: str = "loop.perfect_model"):
    """The perfect-model MPC loop: the plant is one step of the solver's
    own rollout model (mode-correct by construction).  Returns ``run((state0,
    solver0), z=None) -> ((state, solver), logs)``: per step, ``out, solver =
    step(solver, obs_of(state))`` (``z[i]``, the solve's standard normals,
    passed on when given), ``state = plant_step(state, out.action)``, and
    the log row ``log_of(state)``, a tuple of tensors.  The solver state's
    seed and solve index become int64 device tensors; on the card each step
    is one replay of a captured control step."""
    dev = resolve_device(device)

    def control_step(carry, z):
        state, solver = carry
        out, solver = step(solver, obs_of(state), z)
        state = plant_step(state, out.action)
        return (state, solver), log_of(state)

    run = graphs.episode_runner(control_step, lambda carry: log_of(carry[0]), n_steps, dev,
                                graph, label)

    def go(carry: Any, z=None):
        state0, solver0 = carry
        return run((state0, device_counters(solver0, dev)), z)

    return go
