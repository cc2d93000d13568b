"""The port's configuration tree (``config.py``) against the JAX package's:
the JAX ``tests/test_config.py`` cases run on the port, files saved by
either package load in the other node for node, and a loaded tree builds
the port's solver, whose steps on the JAX draws match the JAX solver.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch import config as tcfg
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

from torch_parity import N, shared_z, torch_one_thread  # noqa: F401


# ---------------------------------------------------------------------------
# tests/test_config.py on the port
# ---------------------------------------------------------------------------

def test_roundtrip_default(tmp_path):
    cfg = tcfg.ExperimentConfig()
    path = str(tmp_path / "exp.json")
    tcfg.save_config(cfg, path)
    back = tcfg.load_config(path)
    assert back.solver.mppi.n_samples == cfg.solver.mppi.n_samples
    assert back.gains.kp_roll == cfg.gains.kp_roll
    np.testing.assert_allclose(np.asarray(back.solver.mppi.sigma),
                               np.asarray(cfg.solver.mppi.sigma))
    np.testing.assert_allclose(np.asarray(back.solver.mppi.u_min),
                               np.asarray(cfg.solver.mppi.u_min))
    assert back.solver.model.control_mode == cfg.solver.model.control_mode


def test_roundtrip_modified(tmp_path):
    cfg = tcfg.ExperimentConfig()
    cfg = tcfg.replace_path(cfg, "solver.mppi.lam", 0.05)
    cfg = tcfg.replace_path(cfg, "solver.cost.obstacle_weight", 10.0)
    cfg = tcfg.replace_path(cfg, "solver.cost.obstacle_centers", ((1.0, 2.0, 3.0),))
    path = str(tmp_path / "exp.json")
    tcfg.save_config(cfg, path)
    back = tcfg.load_config(path)
    assert back.solver.mppi.lam == 0.05
    assert back.solver.cost.obstacle_weight == 10.0
    assert back.solver.cost.obstacle_centers == ((1.0, 2.0, 3.0),)


def test_replace_path_is_functional():
    cfg = tcfg.ExperimentConfig()
    cfg2 = tcfg.replace_path(cfg, "solver.mppi.n_samples", 128)
    assert cfg.solver.mppi.n_samples == 4096
    assert cfg2.solver.mppi.n_samples == 128


def test_loaded_config_builds_solver(tmp_path):
    cfg = tcfg.ExperimentConfig()
    cfg = tcfg.replace_path(cfg, "solver.mppi.n_samples", 32)
    cfg = tcfg.replace_path(cfg, "solver.mppi.n_horizon", 8)
    path = str(tmp_path / "exp.json")
    tcfg.save_config(cfg, path)
    back = tcfg.load_config(path)
    step, init = twb.make_whole_body_solver(back.solver, device="cpu", low_k_guard="off")
    out, _ = step(init(back.seed), twb.default_obs(device="cpu"))
    assert out.action.shape == (twb.N_ACTIONS,)


def test_round3_configs_round_trip(tmp_path):
    from quadrotor_manipulator_mppi_tpu_torch.models.fixed_wing import FwVehicleParams
    from quadrotor_manipulator_mppi_tpu_torch.sim.mapped_loop import MappedFlightConfig
    from quadrotor_manipulator_mppi_tpu_torch.sim.occupancy import OccupancyParams

    for cfg in (MappedFlightConfig(margin=0.7), OccupancyParams(resolution=0.2, shape=(10, 12, 6)),
                FwVehicleParams(mass=3.0)):
        p = str(tmp_path / (type(cfg).__name__ + ".json"))
        tcfg.save_config(cfg, p)
        assert tcfg.load_config(p) == cfg


def test_round4_subsystem_configs_round_trip(tmp_path):
    from quadrotor_manipulator_mppi_tpu_torch.sim.geotag import GeotagParams
    from quadrotor_manipulator_mppi_tpu_torch.sim.gimbal import GimbalParams
    from quadrotor_manipulator_mppi_tpu_torch.sim.whole_body_loop import WholeBodyLoopConfig

    for cfg in (GimbalParams(kp_yaw=2.0), GeotagParams(interval=0.5, lat_home_deg=10.0),
                WholeBodyLoopConfig(arm_coeffs_per_control=True, payload_mass=0.5),
                twb.WholeBodyCostParams(stop_weight=4000.0, stop_horizon=1.2)):
        p = str(tmp_path / f"{type(cfg).__name__}.json")
        tcfg.save_config(cfg, p)
        assert tcfg.load_config(p) == cfg


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------

def _jax_trees():
    from quadrotor_manipulator_mppi_tpu.models.fixed_wing import FwVehicleParams
    from quadrotor_manipulator_mppi_tpu.sim.depth_camera import DepthCameraParams
    from quadrotor_manipulator_mppi_tpu.sim.geotag import GeotagParams
    from quadrotor_manipulator_mppi_tpu.sim.gimbal import GimbalParams
    from quadrotor_manipulator_mppi_tpu.sim.mapped_loop import MappedFlightConfig
    from quadrotor_manipulator_mppi_tpu.sim.sensors import GpsParams
    from quadrotor_manipulator_mppi_tpu.sim.whole_body_loop import WholeBodyLoopConfig

    exp = jcfg.replace_path(jcfg.ExperimentConfig(), "solver.cost.obstacle_centers",
                            ((1.0, 2.0, 3.0),))
    return {"experiment": exp,
            "position_schedule": jcfg.ExperimentConfig(solver=jwb.position_mode_params(),
                                                       seed=3),
            "wrench": jwb.wrench_mode_params(),
            "mapped": MappedFlightConfig(margin=0.7),
            "fixed_wing": FwVehicleParams(mass=3.0),
            "camera": DepthCameraParams(width=64, height=48),
            "gimbal": GimbalParams(kp_yaw=2.0),
            "geotag": GeotagParams(interval=0.5),
            "gps": GpsParams(),
            "loop": WholeBodyLoopConfig(arm_coeffs_per_control=True, payload_mass=0.5)}


@pytest.mark.parametrize("name", sorted(_jax_trees()))
def test_jax_file_loads_in_the_port_and_back(tmp_path, name):
    """JAX save_config -> port load_config gives the same tree node for node
    (the port's to_dict of it equals the JAX file), and the port's file of
    it loads in the JAX package equal to the original."""
    tree = _jax_trees()[name]
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jcfg.save_config(tree, jpath)
    port = tcfg.load_config(jpath)
    assert type(port).__name__ == type(tree).__name__
    assert type(port).__module__.startswith("quadrotor_manipulator_mppi_tpu_torch.")
    with open(jpath) as f:
        assert tcfg.to_dict(port) == json.load(f)
    tcfg.save_config(port, tpath)
    back = jcfg.load_config(tpath)
    assert jcfg.to_dict(back) == jcfg.to_dict(tree)
    with open(jpath) as a, open(tpath) as b:
        assert json.load(a) == json.load(b)


def test_registry_holds_every_jax_class():
    assert set(jcfg._REGISTRY) <= set(tcfg._REGISTRY)
    for name in ("LiftDragParams", "DepthCameraParams", "GimbalParams", "GeotagParams",
                 "GpsParams", "WholeBodyLoopConfig", "ExperimentConfig", "HilConfig",
                 "DroneMPPIParams", "ArmMPPIParams", "WindField", "MissionConfig"):
        assert name in tcfg._REGISTRY


def test_convert_reads_through_config_from_dict():
    """convert.config_from_dict is config.from_dict: one reader."""
    d = jcfg.to_dict(jwb.position_mode_params())
    a, b = convert.config_from_dict(d), tcfg.from_dict(d)
    assert tcfg.to_dict(a) == tcfg.to_dict(b) == d


def test_to_dict_writes_tensors_as_ndarrays():
    t = torch.tensor([[1.0, 2.0], [3.0, 4.5]])
    assert tcfg.to_dict({"x": t}) == {"x": {"__ndarray__": [[1.0, 2.0], [3.0, 4.5]],
                                            "dtype": "float32"}}
    back = tcfg.from_dict(tcfg.to_dict({"x": t}))["x"]
    assert isinstance(back, np.ndarray) and np.array_equal(back, t.numpy())


def test_errors_and_registration():
    with pytest.raises(ValueError, match="unregistered config dataclass"):
        tcfg.from_dict({"__dataclass__": "NoSuchParams"})
    with pytest.raises(ValueError, match="unknown sigma schedule"):
        tcfg.from_dict({"__schedule__": {"kind": "spline"}})
    with pytest.raises(TypeError, match="non-serializable callable"):
        tcfg.to_dict({"f": lambda x: x})

    @dataclasses.dataclass(frozen=True)
    class ExtraParams:
        a: float = 1.0

    assert tcfg.register(ExtraParams) is ExtraParams
    assert tcfg.from_dict(tcfg.to_dict(ExtraParams(a=2.0))) == ExtraParams(a=2.0)
    tcfg.register_schedule("double", lambda k=2.0: (lambda obs: k))
    assert tcfg.from_dict({"__schedule__": {"kind": "double", "k": 3.0}})(None) == 3.0


def test_loaded_tree_solves_like_jax(tmp_path):
    """A JAX ExperimentConfig saved at K=32, H=8, loaded by the port, builds
    the port's solver; its 3 steps on the JAX key chain's draws match the
    JAX solver at test_torch_solver.py's 2e-3."""
    exp = jcfg.replace_path(jcfg.ExperimentConfig(), "solver.mppi.n_samples", 32)
    exp = jcfg.replace_path(exp, "solver.mppi.n_horizon", 8)
    path = str(tmp_path / "exp.json")
    jcfg.save_config(exp, path)
    port = tcfg.load_config(path)

    jstep, jinit = jwb.make_whole_body_solver(exp.solver, low_k_guard="off")
    jstep = jax.jit(jstep)
    jstate = jinit(jax.random.key(exp.seed))
    tstep, tinit = twb.make_whole_body_solver(port.solver, device="cpu", low_k_guard="off")
    tstate, tobs = tinit(port.seed), twb.default_obs(device="cpu")
    key = jstate.key
    for _ in range(3):
        key, z = shared_z(key, 32, 8)
        jout, jstate = jstep(jstate, jwb.default_obs())
        tout, tstate = tstep(tstate, tobs, z)
        np.testing.assert_allclose(N(tout.u_seq), np.asarray(jout.u_seq), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(N(tout.action), np.asarray(jout.action), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(N(tstate.u_prev), np.asarray(jstate.u_prev), rtol=2e-3,
                                   atol=2e-3)
