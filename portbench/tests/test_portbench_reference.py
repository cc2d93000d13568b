"""The plain reference against the port on the same inputs, on the CPU at
tiny sizes (the test imports both; the reference imports nothing of the
port)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import inputs  # noqa: E402
from portbench.reference import solve as ref  # noqa: E402
from portbench.reference.frozen.ops import sampling as ref_sampling  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import serving  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wbs  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose  # noqa: E402

CONFIGS = {n: json.loads((ROOT / f"portbench/configs/{n}.json").read_text())
           for n in ("wb_att_k4096", "wb_pos_k512")}
K, H = 64, 10


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.solve, portbench.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'quadrotor_manipulator_mppi_tpu_torch', 'quadrotor_manipulator_mppi_tpu', 'jax'}))"
            % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("seed,step", [(0, 0), (2**63 - 25, 7), (3000000001, 123456)])
def test_philox_draw_equals_the_ports(seed, step):
    a = ref_sampling.philox_normals(seed, step, 40, 6, 11)
    b = sampling.philox_normals(seed, step, 40, 6, 11)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stated_preset_equals_the_ports(name):
    cfg = CONFIGS[name]
    mine = ref.stated(ref.make_params(ref.wbs, cfg))
    theirs = ref.stated(ref.make_params(wbs, cfg))
    assert mine == theirs == {k: cfg[k] for k in mine}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_packed_solves_follow_the_port(name):
    """Five chained packed solves of the port (the kernels' plain versions on
    the CPU) against the reference from the port's carry each time."""
    cfg = CONFIGS[name]
    params = ref.make_params(wbs, cfg, K, H)
    pstep, pinit = serving.make_packed_step(params, device="cpu", low_k_guard="off")
    r = ref.Reference(cfg, "cpu", torch.float64, n_samples=K, n_horizon=H)
    mix = json.loads((ROOT / "portbench/traffic/serve_b1.json").read_text())
    stream = inputs.VehicleStream(11, cfg["task"], mix)
    key = inputs.request_keys(11, 1)[0]
    carry = pinit(key)
    sigma = r.sigma.numpy()
    for i in range(5):
        x = stream.block(0, "packed")[i, 0]
        u_before = carry.u_prev.clone()
        out, carry = pstep(carry, torch.from_numpy(x[:27]), torch.from_numpy(x[27:]))
        want, u_want = r.solve_packed(r.initial_warm_start() if i == 0 else u_before, key, i, x)
        assert np.max(np.abs(out.numpy()[:11] - want.numpy()[:11]) / sigma) < 1e-2
        assert np.max(np.abs(carry.u_prev.numpy() - u_want.numpy()) / sigma) < 1e-2
        assert np.max(np.abs(out.numpy()[11:] - want.numpy()[11:])) < 1e-4


def test_batched_solve_follows_the_port():
    cfg = CONFIGS["wb_att_k4096"]
    params = ref.make_params(wbs, cfg, K, H)
    step, init = wbs.make_whole_body_solver(params, device="cpu", n_scenarios=3,
                                            low_k_guard="off")
    keys = [5, 2**62 + 3, 99]
    state = init(keys)
    mix = json.loads((ROOT / "portbench/traffic/batch_b256.json").read_text())
    x = inputs.VehicleStream(4, cfg["task"], dict(mix, vehicles=3)).block(0, "flat")[0]
    f = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inputs.split_flat(x).items()}
    obs = wbs.WholeBodyObs(*ref.obs_from_fields(f))
    out, new = step(state, obs)
    r = ref.Reference(cfg, "cpu", torch.float64, n_samples=K, n_horizon=H)
    for b in range(3):
        want, u_want = r.solve_fields(r.initial_warm_start(), keys[b], 0,
                                      inputs.split_flat(x[b]))
        got = torch.cat([out.action[b], out.qdes[b], out.vdes[b]]).numpy()
        assert np.max(np.abs(got[:11] - want.numpy()[:11]) / r.sigma.numpy()) < 1e-2
        assert np.max(np.abs(new.u_prev[b].numpy() - u_want.numpy())) < 1e-2


@pytest.mark.parametrize("name,loop,n", [
    ("wb_pos_k512", {"arm_coeffs_per_control": True, "plant_kernel": True}, 2),
    ("wb_att_k4096", {}, 1),
])
def test_episode_calls_follow_the_port(name, loop, n):
    """The port's eager episode (the plant kernel's plain version on the CPU)
    in two calls, the second from the carry the first returned, against the
    reference's steps from the same start and from the port's carry."""
    from portbench import drivers

    cfg = CONFIGS[name]
    mix = {"vehicles": n, "base_box_m": 0.3, "target_box_m": 0.15}
    st = inputs.episode_start(21, 0, cfg["task"], mix)
    port = drivers.PortEpisode(cfg, "cpu", K, H, n, 3, loop)
    carry, logs = port.call(port.start(st))
    rows = port.rows(carry, np.arange(n))
    _, logs2 = port.call(carry)
    r = ref.Reference(cfg, "cpu", torch.float64, n_samples=K, n_horizon=H)
    want, want_rows = r.episode(st, loop, 3)
    want2, _ = r.episode(st, loop, 3, rows, step0=3)
    for f in ref.LOG_FIELDS:
        assert np.max(np.abs(logs[f] - want[f])) < 1e-4, f
        assert np.max(np.abs(logs2[f] - want2[f])) < 1e-4, f
    assert np.max(np.abs(rows["base"]["pos"] - want_rows["base"]["pos"])) < 1e-4
    assert np.max(np.abs(rows["u_prev"] - want_rows["u_prev"]) / r.sigma.numpy()) < 1e-2


def test_episode_restart_needs_the_right_solve_index():
    """From the port's carry, the reference at another solve index draws
    other noise and parts from the port's second call."""
    from portbench import drivers

    cfg, loop = CONFIGS["wb_pos_k512"], {"arm_coeffs_per_control": True}
    st = inputs.episode_start(22, 0, cfg["task"], {"vehicles": 2, "base_box_m": 0.3,
                                                   "target_box_m": 0.15})
    port = drivers.PortEpisode(cfg, "cpu", K, H, 2, 3, loop)
    carry, _ = port.call(port.start(st))
    _, logs2 = port.call(carry)
    r = ref.Reference(cfg, "cpu", torch.float64, n_samples=K, n_horizon=H)
    good, _ = r.episode(st, loop, 3, port.rows(carry, np.arange(2)), step0=3)
    bad, _ = r.episode(st, loop, 3, port.rows(carry, np.arange(2)), step0=2)
    assert np.max(np.abs(logs2["base_pos"] - good["base_pos"])) < 1e-5
    assert np.max(np.abs(logs2["base_pos"] - bad["base_pos"])) > 10 * np.max(
        np.abs(logs2["base_pos"] - good["base_pos"]))
