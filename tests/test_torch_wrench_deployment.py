"""The direct-wrench deployment (``portbench/configs/wb_wrench_k4096.json``)
on the port against the benchmark's float64 plain reference
(``portbench/reference``), on the CPU at K=64, H=10: the preset the file
names, chained packed solves, a batched solve of three vehicles and the
wrench RNEA episode in two calls, the second from the first's carry.  The
kernels run their plain versions on the CPU; the card's kernels are held to
the same reference by the benchmark's own check."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import drivers, inputs  # noqa: E402
from portbench.reference import solve as ref  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import serving  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wbs  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose  # noqa: E402

CFG = json.loads((ROOT / "portbench/configs/wb_wrench_k4096.json").read_text())
K, H = 64, 10
TOL_PLAN = 1e-2       # action and warm start, over sigma
TOL_SETPOINT = 1e-4   # qdes, vdes (rad, rad/s)
TOL_LOGS = 1e-4       # every logged field of the episode
RNEA = {"arm_coeffs_per_control": False, "mass_matrix_per_control": False}


def reference() -> ref.Reference:
    return ref.Reference(CFG, "cpu", torch.float64, n_samples=K, n_horizon=H)


def mix(name: str) -> dict:
    return json.loads((ROOT / f"portbench/traffic/{name}.json").read_text())


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


def plan_gap(got, want, sigma) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                        / sigma))


@pytest.mark.parametrize("who,module", [("port", wbs), ("reference", ref.wbs)])
def test_the_file_builds_wrench_mode_params(who, module):
    for size in ((None, None), (K, H)):
        p = ref.make_params(module, CFG, *size)
        want = module.wrench_mode_params(n_samples=size[0] or 4096, n_horizon=size[1] or 50)
        assert same(p, want) and not same(p, module.WholeBodyMPPIParams())
        drivers.check_preset(p, CFG, who)
    assert p.model.control_mode == "wrench" and p.model.rate_damping == 12.0
    assert p.model.couple_arm_gravity is False
    assert (p.cost.stop_weight, p.cost.stop_horizon) == (8000.0, 1.2)
    assert p.mppi.sigma_scale_fn.__qmm_schedule__ == {"kind": "ee_error", "r0": 0.25,
                                                      "floor": 0.02, "base_floor": 0.005}
    assert p.mppi.nominal_action[0] > 0.0 and not np.any(p.mppi.nominal_action[1:])


def test_chained_packed_solves_follow_the_reference():
    """Five packed solves of the port, each from the carry the previous one
    left, against the reference from the same warm start, key and index."""
    params = ref.make_params(wbs, CFG, K, H)
    pstep, pinit = serving.make_packed_step(params, device="cpu", low_k_guard="off")
    r = reference()
    sigma = r.sigma.numpy()
    stream = inputs.VehicleStream(2**31 + 17, CFG["task"], mix("serve_b1"))
    key = inputs.request_keys(2**31 + 17, 1)[0]
    carry = pinit(key)
    for i in range(5):
        x = stream.block(0, "packed")[i, 0]
        u_before = carry.u_prev.clone()
        out, carry = pstep(carry, torch.from_numpy(x[:27]), torch.from_numpy(x[27:]))
        want, u_want = r.solve_packed(r.initial_warm_start() if i == 0 else u_before, key, i, x)
        out, want = out.numpy(), want.numpy()
        assert plan_gap(out[:11], want[:11], sigma) < TOL_PLAN, i
        assert plan_gap(carry.u_prev.numpy(), u_want.numpy(), sigma) < TOL_PLAN, i
        assert np.max(np.abs(out[11:] - want[11:])) < TOL_SETPOINT, i


def test_batched_solves_follow_the_reference_vehicle_by_vehicle():
    """Two chained solves of three vehicles in one batch (a per-vehicle (B, A)
    sigma scale from the base floor), each vehicle against its own reference
    solve."""
    params = ref.make_params(wbs, CFG, K, H)
    step, init = wbs.make_whole_body_solver(params, device="cpu", n_scenarios=3,
                                            low_k_guard="off")
    keys = [5, 2**62 + 3, 3000000019]
    state = init(keys)
    r = reference()
    sigma = r.sigma.numpy()
    stream = inputs.VehicleStream(2**31 + 4, CFG["task"], dict(mix("batch_b256"), vehicles=3))
    u = [r.initial_warm_start()] * 3
    for i in range(2):
        x = stream.block(0, "flat")[i]
        f = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inputs.split_flat(x).items()}
        out, state = step(state, wbs.WholeBodyObs(*ref.obs_from_fields(f)))
        for b in range(3):
            want, u[b] = r.solve_fields(u[b], keys[b], i, inputs.split_flat(x[b]))
            got = torch.cat([out.action[b], out.qdes[b], out.vdes[b]]).numpy()
            want = want.numpy()
            assert plan_gap(got[:11], want[:11], sigma) < TOL_PLAN, (i, b)
            assert plan_gap(state.u_prev[b].numpy(), u[b].numpy(), sigma) < TOL_PLAN, (i, b)
            assert np.max(np.abs(got[11:] - want[11:])) < TOL_SETPOINT, (i, b)
            u[b] = state.u_prev[b].double()


def rows(carry) -> dict:
    """The port's carry as the reference's state rows (one vehicle)."""
    plant, solver = carry[0], carry[1]

    def host(x):
        return x.detach().double().numpy()[None]

    return {"base": {f: host(getattr(plant.base, f)) for f in plant.base._fields},
            "q": host(plant.q), "qdot": host(plant.qdot),
            "ctrl": {f: host(getattr(plant.ctrl, f)) for f in plant.ctrl._fields},
            "u_prev": host(solver.u_prev)}


def test_rnea_episode_calls_follow_the_reference():
    """The port's wrench episode on the per-substep RNEA plant (the direct-
    wrench branch of ``physics_tick``) in two calls of three steps, the
    second from the carry the first returned, against the reference's steps
    from the same start and from the port's carry at solve index 3."""
    params = ref.make_params(wbs, CFG, K, H)
    run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**RNEA),
                                      n_control_steps=3, low_k_guard="off", device="cpu")
    _, init = wbs.make_whole_body_solver(params, device="cpu", low_k_guard="off")
    st = inputs.episode_start(2**31 + 23, 0, CFG["task"], mix("reach_b1"))
    plant = wbl.init_plant(params.model.vehicle, pos=np.asarray(st["pos"][0]), device="cpu")
    target = Pose(position=torch.as_tensor(st["ee_pos"][0], dtype=torch.float32),
                  quat=torch.as_tensor(st["ee_quat"][0], dtype=torch.float32))
    base_target = torch.as_tensor(st["base_target"][0], dtype=torch.float32)
    carry, logs = run(plant, init(st["keys"][0]), target, base_target)
    mid = rows(carry)
    _, logs2 = run(*carry[:2], target, base_target)
    r = reference()
    want, want_rows = r.episode(st, RNEA, 3)
    want2, _ = r.episode(st, RNEA, 3, mid, step0=3)
    for f in ref.LOG_FIELDS:
        got, got2 = (getattr(lg, f).double().numpy()[None] for lg in (logs, logs2))
        assert np.max(np.abs(got - want[f])) < TOL_LOGS, f
        assert np.max(np.abs(got2 - want2[f])) < TOL_LOGS, f
    assert np.max(np.abs(mid["base"]["pos"] - want_rows["base"]["pos"])) < TOL_LOGS
    assert plan_gap(mid["u_prev"], want_rows["u_prev"], r.sigma.numpy()) < TOL_PLAN
