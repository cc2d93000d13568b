"""Configurations as data: the preset by name, sphere obstacles from the file,
and the check that refuses a port whose preset differs from the file; on the
CPU, for the port's ``solver.whole_body`` and the reference's frozen copy."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import drivers  # noqa: E402
from portbench.reference import solve as ref  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wbs  # noqa: E402

CONFIGS = {n: json.loads((ROOT / f"portbench/configs/{n}.json").read_text())
           for n in ("wb_att_k4096", "wb_pos_k512")}
MODULES = {"port": wbs, "reference": ref.wbs}
OBSTACLES = {"weight": 40.0, "centers": [[0.4, 0.3, 1.9], [-0.2, 0.5, 2.3]],
             "radii": [0.15, 0.25]}


def same(a, b) -> bool:
    """Field for field: dataclasses by their fields, arrays by value, a sigma
    schedule by its declared identity."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if callable(a):
        return (callable(b) and a.__qualname__ == b.__qualname__
                and getattr(a, "__qmm_schedule__", None) == getattr(b, "__qmm_schedule__", None))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
    return type(a) is type(b) and a == b


def parent_params(module, config: dict, k=None, h=None):
    """The preset as the harness built it before presets were named:
    attitude or position, K and H from the file unless given."""
    k, h = int(k or config["n_samples"]), int(h or config["n_horizon"])
    if config["preset"] == "attitude":
        p = module.WholeBodyMPPIParams()
        return dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, n_samples=k, n_horizon=h))
    return module.position_mode_params(n_samples=k, n_horizon=h)


def from_file(tmp_path, config: dict) -> dict:
    path = tmp_path / f"{config['name']}.json"
    path.write_text(json.dumps(config, indent=2))
    return json.loads(path.read_text())


def wrench_config() -> dict:
    return dict(CONFIGS["wb_att_k4096"], name="wb_wrench_k4096", preset="wrench",
                control_mode="wrench", sigma=[8.0, 1.2, 1.2, 0.5] + [1.0] * 7)


def obstacle_config(**obstacles) -> dict:
    return dict(CONFIGS["wb_att_k4096"], name="wb_att_obs", n_obstacles=2,
                obstacles=dict(OBSTACLES, **obstacles))


@pytest.mark.parametrize("size", [(None, None), (64, 10)])
@pytest.mark.parametrize("who", sorted(MODULES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_existing_configurations_build_the_parents_params(name, who, size):
    mod, cfg = MODULES[who], CONFIGS[name]
    assert same(ref.make_params(mod, cfg, *size), parent_params(mod, cfg, *size))
    assert not same(ref.make_params(mod, cfg, *size), parent_params(mod, cfg, 32, 10))


@pytest.mark.parametrize("who", sorted(MODULES))
def test_a_wrench_file_builds_wrench_mode_params(tmp_path, who):
    mod, cfg = MODULES[who], from_file(tmp_path, wrench_config())
    p = ref.make_params(mod, cfg, 64, 10)
    assert same(p, mod.wrench_mode_params(n_samples=64, n_horizon=10))
    assert p.model.control_mode == "wrench" and p.model.rate_damping == 12.0
    assert same(ref.make_params(mod, cfg), mod.wrench_mode_params(n_samples=4096, n_horizon=50))
    drivers.check_preset(p, cfg, who)
    assert not same(p, mod.WholeBodyMPPIParams())


@pytest.mark.parametrize("cfg", [wrench_config(), obstacle_config()], ids=["wrench", "obstacles"])
def test_port_and_reference_state_the_same_preset(cfg):
    assert ref.stated(ref.make_params(wbs, cfg)) == ref.stated(ref.make_params(ref.wbs, cfg))


@pytest.mark.parametrize("who", sorted(MODULES))
def test_a_file_with_obstacles_builds_them(tmp_path, who):
    mod, cfg = MODULES[who], from_file(tmp_path, obstacle_config())
    p = ref.make_params(mod, cfg)
    assert p.cost.obstacle_weight == 40.0
    assert p.cost.obstacle_centers == ((0.4, 0.3, 1.9), (-0.2, 0.5, 2.3))
    assert p.cost.obstacle_radii == (0.15, 0.25)
    plain = dataclasses.replace(p, cost=dataclasses.replace(
        p.cost, obstacle_weight=0.0, obstacle_centers=(), obstacle_radii=()))
    assert same(plain, ref.make_params(mod, CONFIGS["wb_att_k4096"]))
    st = ref.stated(p)
    assert st["n_obstacles"] == 2 and st["obstacles"] == OBSTACLES
    drivers.check_preset(p, cfg, who)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stated_names_obstacles_only_where_there_are_any(name):
    st = ref.stated(ref.make_params(wbs, CONFIGS[name]))
    assert "obstacles" not in st and st["n_obstacles"] == 0
    drivers.check_preset(ref.make_params(wbs, CONFIGS[name]), CONFIGS[name], "the port")


@pytest.mark.parametrize("port_cfg", [
    obstacle_config(radii=[0.15, 0.3]),
    obstacle_config(centers=[[0.4, 0.3, 1.9], [-0.2, 0.5, 2.4]]),
    obstacle_config(weight=41.0),
    CONFIGS["wb_att_k4096"],
], ids=["radii", "centers", "weight", "none"])
def test_check_preset_refuses_a_port_with_other_obstacles(port_cfg):
    with pytest.raises(SystemExit, match="differs from the configuration file"):
        drivers.check_preset(ref.make_params(wbs, port_cfg), obstacle_config(), "the port")


def test_check_preset_refuses_obstacles_the_file_does_not_state():
    with pytest.raises(SystemExit, match="differs from the configuration file"):
        drivers.check_preset(ref.make_params(wbs, obstacle_config()), CONFIGS["wb_att_k4096"],
                             "the port")


@pytest.mark.parametrize("bad,says", [
    ({"preset": "hover"}, "unknown preset 'hover'"),
    ({"obstacles": dict(OBSTACLES, height=1.0)}, "needs exactly weight, centers, radii"),
    ({"obstacles": {"weight": 1.0, "centers": [[0.0, 0.0, 1.0]]}}, "needs exactly"),
    ({"obstacles": dict(OBSTACLES, radii=[0.1])}, "one [x, y, z] centre per radius"),
    ({"obstacles": dict(OBSTACLES, centers=[[0.4, 0.3], [0.0, 0.0]])}, "one [x, y, z] centre"),
], ids=["preset", "extra-key", "missing-key", "count", "width"])
def test_an_unknown_preset_or_key_exits_with_a_message(bad, says):
    with pytest.raises(SystemExit) as e:
        ref.make_params(ref.wbs, dict(CONFIGS["wb_att_k4096"], **bad))
    assert says in str(e.value)
