"""Shared scenario plumbing: the command line's report, checkpoint and log
files, the hover start of the rotorcraft scenarios, the 1 kHz tick episode
and the perfect-model MPC loop.

Port of the JAX package's ``scenarios/common.py``.  The port's scenarios
are keyword functions that return their metrics; the command line
(``run.py``) reports them through :func:`finish`, and a scenario that
checkpoints goes through :func:`maybe_resume` and :func:`maybe_save`.
Where the JAX package scans an episode, the port runs it
through ``utils/graphs.episode_runner``: on the card one captured control
step replayed per step.  A tick episode (:func:`tick_episode`) captures one
control period of 10 plant ticks as that step, its per-tick logs written
into preallocated buffers, and checkpoints its carry through
``utils/checkpoint``.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models import multirotor as mr
from ..solver.mppi import device_counters
from ..utils import checkpoint, graphs
from ..utils.device import resolve_device


def maybe_resume(resume: Optional[str], carry0: Any, device=None) -> Any:
    """``resume``, a checkpoint path: ``carry0`` restored from it (the
    Philox keys and solve indices exactly, so a resumed episode continues
    the noise stream the uninterrupted run would have drawn); tensors go to
    their ``carry0`` leaf's device, or ``device``."""
    if resume:
        carry0 = checkpoint.restore(resume, carry0, device=device)
        print(f"resumed state from {resume}", file=sys.stderr)
    return carry0


def maybe_save(save_state: Optional[str], carry: Any) -> None:
    """``save_state``, a checkpoint path: the final episode carry saved."""
    if save_state:
        checkpoint.save(save_state, carry)
        print(f"saved state to {save_state}", file=sys.stderr)


def finish(name: str, metrics: dict, log_arrays: Optional[dict] = None,
           save_log: Optional[str] = None) -> dict:
    """The command line's report: the logs written to ``save_log`` (.npz)
    if given, then one JSON line with ``"scenario"`` first.  Returns the
    reported object."""
    if save_log:
        np.savez(save_log, **(log_arrays or {}))
        metrics = {**metrics, "log": save_log}
    out = {"scenario": name, **metrics}
    print(json.dumps(out), flush=True)
    return out


def hover_plant(veh: mr.MultirotorParams, pos, dtype=torch.float32,
                device="cuda") -> mr.MultirotorState:
    """The plant at rest at ``pos`` with the rotors at hover speed: the
    standing start of every rotorcraft scenario."""
    dev = resolve_device(device)
    plant = mr.init_state(veh, pos=pos, dtype=dtype, device=dev)
    return plant._replace(rotor_speed=torch.full((veh.n_rotors,), veh.hover_rotor_speed(),
                                                 dtype=dtype, device=dev))


TICK_DT = 0.001       # s: the plant and flight-control rate (1 kHz)
TICKS_PER_STEP = 10   # plant ticks per captured control step (100 Hz)


def tick_episode(tick: Callable, log_like: Callable, n_ticks: int, device="cuda",
                 graph: bool = True, draw: Optional[Callable] = None):
    """The rotorcraft scenarios' episode: ``n_ticks`` calls of ``tick(carry,
    i, noise) -> (carry, log_row)``, the JAX package's ``lax.scan`` of one
    tick.  ``i`` is the tick index, a () int32 device tensor counting from
    0 (the scan's ``xs``), and ``noise`` that tick's explicit standard
    normals (``z[i]``) or None; ``log_like(carry)`` gives one tick's log
    row (its shapes and dtypes size the buffers).  ``draw(carry, i)``, if
    given, draws the standard normals of a control step's ticks at once,
    (TICKS_PER_STEP, ...), at its first tick ``i``, where no ``z`` is given.

    Returns ``run(carry, z=None, save_state=None, resume=None) -> (final
    carry, logs)``, each log field stacked over the ticks.  The ticks run
    in control steps of ``TICKS_PER_STEP``: on the card (``graph=True``)
    one step is captured at the first call and replayed per step, every
    field of the carry a tensor; ``graph=False``, and the CPU, run the same
    step eagerly.  When ``n_ticks`` is not a multiple of ``TICKS_PER_STEP``
    the last step runs whole and the logs keep the first ``n_ticks`` rows.
    ``resume`` restores the carry from a checkpoint before the run (the
    tick index starts from 0 again, as the JAX scan's does) and
    ``save_state`` writes the final carry to one.  ``z`` holds the
    standard normals of every tick, (n_ticks, ...)."""
    dev = resolve_device(device)
    n_steps = math.ceil(n_ticks / TICKS_PER_STEP)
    padded = n_steps * TICKS_PER_STEP

    def control_step(state, z_step):
        carry, i = state
        if z_step is None and draw is not None:
            z_step = draw(carry, i)
        rows = []
        for j in range(TICKS_PER_STEP):
            carry, row = tick(carry, i, None if z_step is None else z_step[j])
            rows.append(row)
            i = i + 1
        return (carry, i), tuple(torch.stack(f) for f in zip(*rows))

    def row_like(state):
        return tuple(x.expand((TICKS_PER_STEP,) + tuple(x.shape)) for x in log_like(state[0]))

    run_steps = graphs.episode_runner(control_step, row_like, n_steps, dev, graph)

    def run(carry: Any, z: Optional[torch.Tensor] = None, save_state: Optional[str] = None,
            resume: Optional[str] = None):
        carry = maybe_resume(resume, carry, dev)
        if z is not None:
            if len(z) != n_ticks:
                raise ValueError(f"z carries {len(z)} ticks, the episode {n_ticks}")
            z = torch.cat([z, z[-1:].expand((padded - n_ticks,) + tuple(z.shape[1:]))]) \
                if padded > n_ticks else z
            z = z.reshape((n_steps, TICKS_PER_STEP) + tuple(z.shape[1:]))
        i0 = torch.zeros((), dtype=torch.int32, device=dev)
        (final, _), logs = run_steps((carry, i0), z)
        maybe_save(save_state, final)
        return final, tuple(x.reshape((padded,) + tuple(x.shape[2:]))[:n_ticks] for x in logs)

    return run


def perfect_model_episode(step: Callable, obs_of: Callable, plant_step: Callable,
                          log_of: Callable, n_steps: int, device="cuda", graph: bool = True):
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
                                graph)

    def go(carry: Any, z=None):
        state0, solver0 = carry
        return run((state0, device_counters(solver0, dev)), z)

    return go
