"""The port's reach-gate scoring (``evaluation/metrics``) equals the JAX
package's exactly, on seeded error traces: converging, never converging,
converging at the last possible window, and grazing the gate."""

import numpy as np
import pytest

from quadrotor_manipulator_mppi_tpu.evaluation import metrics as jmetrics
from quadrotor_manipulator_mppi_tpu_torch.evaluation import metrics


def _traces():
    rng = np.random.default_rng(0)
    t = np.arange(400)
    converging = 0.3 * np.exp(-t / 40.0) + rng.uniform(0, 0.002, t.size)
    never = 0.006 + rng.uniform(0, 0.01, t.size)
    last_window = np.full(400, 0.02)
    last_window[-50:] = 0.001                      # held exactly hold_ticks at the end
    grazing = 0.02 + 0.0 * t
    grazing[::37] = 0.001                          # single dips never held
    relapsing = converging.copy()
    relapsing[300:320] = 0.009                     # converges, then leaves the gate
    return {"converging": converging, "never": never, "last_window": last_window,
            "grazing": grazing, "relapsing": relapsing}


@pytest.mark.parametrize("name", sorted(_traces()))
def test_reach_convergence_equals_jax(name):
    err = _traces()[name]
    for gate, hold in ((0.005, 50), (0.003, 10)):
        assert metrics.reach_convergence(err, gate, hold) == \
            jmetrics.reach_convergence(err, gate, hold)


@pytest.mark.parametrize("name", sorted(_traces()))
def test_episode_quality_equals_jax(name):
    err = _traces()[name]
    meas = err * 1.3 + 0.0005
    got = metrics.episode_quality(err, meas, tail_n=100)
    assert got == jmetrics.episode_quality(err, meas, tail_n=100)
    if name == "never":
        assert got["converged_step"] == -1 and got["reach_gate_first_step"] == -1
    if name == "last_window":
        assert got["converged_step"] == 350 and got["held_fraction_after_converge"] == 1.0
