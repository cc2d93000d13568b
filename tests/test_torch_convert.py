"""Carrying the JAX package's configuration tree and solver state across
(``convert.py``), and the port's hygiene: it imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU quietly."""

import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import quadrotor_manipulator_mppi_tpu_torch as port
from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.solver import serving
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

from torch_parity import N, obs_to_port, perturbed_obs, torch_one_thread  # noqa: F401

PRESETS = {"attitude": jwb.WholeBodyMPPIParams, "position": jwb.position_mode_params,
           "wrench": jwb.wrench_mode_params}
PKG_DIR = Path(port.__file__).resolve().parent


def _assert_same_tree(a, b, path="params"):
    """Every field of two dataclass trees (JAX side ``a``, port side ``b``)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        names_a = [f.name for f in dataclasses.fields(a)]
        assert names_a == [f.name for f in dataclasses.fields(b)], path
        for name in names_a:
            _assert_same_tree(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif callable(a):
        assert a.__qmm_schedule__ == b.__qmm_schedule__, path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_params_from_dict_reproduces_every_field(preset):
    jp = PRESETS[preset]()
    tp = convert.params_from_dict(jcfg.to_dict(jp))
    assert isinstance(tp, twb.WholeBodyMPPIParams)
    _assert_same_tree(jp, tp)
    # and the port's own preset is the same tree
    _assert_same_tree(jp, {"attitude": twb.WholeBodyMPPIParams,
                           "position": twb.position_mode_params,
                           "wrench": twb.wrench_mode_params}[preset]())


@pytest.mark.parametrize("preset", ["position", "wrench"])
def test_carried_schedule_scales_like_jax(preset):
    jp = PRESETS[preset]()
    tp = convert.params_from_dict(jcfg.to_dict(jp))
    spec = tp.mppi.sigma_scale_fn.__qmm_schedule__
    assert (spec["r0"], spec["floor"]) == (0.25, 0.02)
    assert spec.get("base_floor") == (0.005 if preset == "wrench" else None)
    jobs = perturbed_obs(jwb.default_obs())
    np.testing.assert_allclose(N(tp.mppi.sigma_scale_fn(obs_to_port(jobs))),
                               np.asarray(jp.mppi.sigma_scale_fn(jobs)), rtol=1e-5)


def test_params_from_dict_rejects_foreign_trees():
    with pytest.raises(ValueError, match="no counterpart"):
        convert.params_from_dict({"__dataclass__": "MissionConfig"})
    with pytest.raises(ValueError, match="expected a WholeBodyMPPIParams"):
        convert.params_from_dict(jcfg.to_dict(jwb.WholeBodyMPPIParams().model))
    with pytest.raises(ValueError, match="unknown sigma schedule"):
        convert.params_from_dict({"__schedule__": {"kind": "spline"}})


def test_state_from_numpy_matches_jax_init():
    jp = jwb.position_mode_params(n_samples=128, n_horizon=10)
    _, jinit = jwb.make_whole_body_solver(jp)
    js = jinit(jax.random.key(0))
    st = convert.state_from_numpy(np.asarray(js.u_prev), np.asarray(js.sigma), seed=2**40 + 1,
                                  device="cpu", step=3)
    assert st.u_prev.dtype == torch.float32 and st.u_prev.shape == (10, 11)
    np.testing.assert_array_equal(N(st.sigma), np.asarray(js.sigma))
    assert (st.seed, st.step) == (2**40 + 1, 3)
    step, _ = twb.make_whole_body_solver(convert.params_from_dict(jcfg.to_dict(jp)),
                                         device="cpu")
    out, st2 = step(st, twb.default_obs(device="cpu"))
    assert st2.step == 4 and bool(torch.isfinite(out.u_seq).all())


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'quadrotor_manipulator_mppi_tpu')\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG_DIR.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_names_jax_or_the_jax_package():
    imports = re.compile(
        r"^\s*(import|from)\s+(jax\b|quadrotor_manipulator_mppi_tpu(\.|\s|$))"
        r"|import_module\(\s*['\"](jax|quadrotor_manipulator_mppi_tpu)['\".]",
        re.M,
    )
    sources = sorted(PKG_DIR.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        assert not imports.search(path.read_text()), path


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = twb.position_mode_params(n_samples=128, n_horizon=10)
    for build in (lambda: twb.make_whole_body_solver(params),
                  lambda: serving.make_packed_step(params),
                  lambda: twb.default_obs(),
                  lambda: convert.state_from_numpy(np.zeros((10, 11)), np.ones(11), 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the plain pipeline is a CPU reference, never a stand-in on a device
    with pytest.raises(ValueError, match="CPU reference"):
        twb.make_whole_body_solver(params, device="meta", backend="torch")


def test_loop_config_and_gains_trees_load():
    from quadrotor_manipulator_mppi_tpu.sim import flight_control as jfc
    from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl

    for tree in (jwbl.WholeBodyLoopConfig(arm_coeffs_per_control=True, plant_kernel=True,
                                          tube_gain=1.1),
                 jwbl.WholeBodyLoopConfig(), jfc.FlightGains(kp_x=3.5, kd_y=1.0),
                 jfc.SIM_TUNED_GAINS):
        got = convert.config_from_dict(jcfg.to_dict(tree))
        _assert_same_tree(tree, got)
    with pytest.raises(ValueError, match="expected a WholeBodyMPPIParams"):
        convert.params_from_dict(jcfg.to_dict(jwbl.WholeBodyLoopConfig()))


def test_plant_from_numpy_round_trips_a_jax_plant():
    import jax.numpy as jnp

    from quadrotor_manipulator_mppi_tpu.ops.pallas import plant_kernel as jpk
    from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl
    from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk

    rng = np.random.default_rng(5)
    plant = jwbl.init_plant(jwb.position_mode_params().model.vehicle)
    vec = np.asarray(jpk.pack_plant(plant)) + rng.normal(0, 0.05, 46).astype(np.float32)
    tplant = convert.plant_from_numpy(vec, device="cpu")
    np.testing.assert_array_equal(N(pk.pack_plant(tplant)), vec)
    np.testing.assert_array_equal(N(tplant.base.quat), vec[3:7])
    np.testing.assert_array_equal(N(tplant.ctrl.n_hat), vec[44:46])
    back = jpk.unpack_plant(jnp.asarray(N(pk.pack_plant(tplant))), plant)
    np.testing.assert_array_equal(np.asarray(back.qdot), vec[28:35])
    with pytest.raises(ValueError, match="plant vector"):
        convert.plant_from_numpy(vec[:45], device="cpu")


def test_closed_loop_entry_points_default_to_the_card(monkeypatch):
    from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk
    from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
    from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = twb.position_mode_params(n_samples=128, n_horizon=10)
    for build in (lambda: wbl.make_whole_body_episode(params),
                  lambda: wbl.init_plant(params.model.vehicle),
                  lambda: pk.make_plant_tick_kernel(params.model.vehicle, fc.FlightGains(),
                                                    params.model.chain(), extra_mass=5.54),
                  lambda: serving.make_bridge_step(params),
                  lambda: convert.plant_from_numpy(np.zeros(46))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
