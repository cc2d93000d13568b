"""Reach-gate scoring of a closed-loop episode.

A copy of the JAX package's ``evaluation/metrics.py`` functions the port's
episode is scored with (plain NumPy on host arrays): the debounced reach
convergence and the single-episode reach quality.
"""

from __future__ import annotations

import numpy as np


def reach_convergence(err, gate: float = 0.005, hold_ticks: int = 50):
    """Debounced reach convergence: the first step from which ``err < gate``
    holds ``hold_ticks`` consecutive steps (a single grazing dip does not
    count).  Returns ``(converged_step, held_fraction_after)``, or
    ``(-1, 0.0)`` when the episode never converges."""
    r = np.asarray(err) < gate
    run = 0
    for i, hit in enumerate(r):
        run = run + 1 if hit else 0
        if run >= hold_ticks:
            conv = i - hold_ticks + 1
            return conv, float(r[conv:].mean())
    return -1, 0.0


def episode_quality(l1_cmd, l1_meas, tail_n, gate=0.005):
    """Reach quality of one episode: the first step the reach gate (L1 of
    the commanded EE position < 5 mm) is met and the fraction held after
    it, the debounced convergence step with the fraction held after it,
    and tail statistics of the commanded and the measured EE error."""
    l1_cmd = np.asarray(l1_cmd)
    l1_meas = np.asarray(l1_meas)
    tail = slice(-tail_n, None)
    reached = l1_cmd < gate
    first = int(np.argmax(reached)) if reached.any() else -1
    held = float(reached[first:].mean()) if first >= 0 else 0.0
    conv, held_conv = reach_convergence(l1_cmd, gate)
    return {
        "reach_gate_first_step": first,
        "held_fraction_after_reach": round(held, 3),
        "converged_step": conv,
        "held_fraction_after_converge": round(held_conv, 3),
        "l1_cmd_tail_mean_mm": round(float(l1_cmd[tail].mean()) * 1000, 2),
        "l1_cmd_tail_max_mm": round(float(l1_cmd[tail].max()) * 1000, 2),
        "l1_meas_tail_mean_mm": round(float(l1_meas[tail].mean()) * 1000, 2),
        "l1_meas_tail_max_mm": round(float(l1_meas[tail].max()) * 1000, 2),
    }
