"""``tests/torch_drift.py`` at a tiny size: the port's whole-body episode fed
the JAX episode's own draws stays with it over the first steps (the
default loop, the per-substep RNEA plant), and the JAX episode against
itself from a moved start reports the move."""

import pytest

import torch_drift

TINY = ["--k", "64", "--h", "8", "--steps", "10", "--chunk", "5", "--threads", "1"]


@pytest.mark.parametrize("mode", ["attitude", "wrench"])
def test_port_tracks_the_jax_episode_on_its_draws(mode):
    r = torch_drift.main(["--mode", mode, *TINY])
    assert r["against"] == "port" and r["steps"] == 10
    assert r["first_step_over_tol"] == {"ee_err": -1, "base_pos": -1, "l1_cmd": -1}
    assert max(r["max_diff"].values()) < 1e-4
    assert set(r["jax"]) == set(r["other"]) == {"converged_step", "held", "base_exc_max_m"}


def test_jax_against_itself_from_a_moved_start():
    r = torch_drift.main(["--against", "jax", "--perturb", "1e-6", *TINY])
    assert r["perturb"] == 1e-6
    assert 0.5e-6 < r["diff_at"]["0"]["base_pos"] < 2e-6
