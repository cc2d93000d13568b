"""Single-solver scenarios of the port: the reference's arm node.

Port of ``run_arm_reach`` of the JAX package's ``scenarios/solvers.py``,
as a function that returns the scenario's metrics (the command line and
its output files are not ported).
"""

from __future__ import annotations

from ..sim import arm_loop
from ..solver import arm as arm_solver
from ..utils.device import resolve_device


def run_arm_reach(seed: int = 0, steps: int = 800, device="cuda") -> dict:
    """The arm node at its preset (K=100, H=32, A=7): phase 1 homes the arm,
    MPPI takes over and reaches for the demo target.  Returns the JAX
    scenario's metrics: whether MPPI engaged (``phase2``) and the least and
    last L1 error of the commanded EE position."""
    dev = resolve_device(device)
    params = arm_solver.ArmMPPIParams()
    _, init = arm_solver.make_arm_solver(params, device=dev)
    run = arm_loop.make_arm_episode(params=params, n_control_steps=steps, device=dev)
    final, (_, err, _) = run(arm_loop.init_arm_loop(init(seed), device=dev))
    err = err.cpu()
    return {"phase2": bool(final.phase2),
            "min_ee_err_m": round(float(err.min()), 4),
            "final_ee_err_m": round(float(err[-1]), 4)}
