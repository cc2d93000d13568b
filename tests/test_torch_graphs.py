"""The solve index on the device and the CUDA-graph runner of the port.

CPU cases: a tensor solve index draws exactly what the int draws (the
plain Philox draw, the kernels' plain noise, the plain pipeline), the tree
helpers of ``utils/graphs``, and ``graph=True`` on the CPU running the
eager call with the same result (the serving solve, the bridge head, the
whole-body, drone and arm episodes, the scenario episodes: perfect-model
whole-body and multirotor, fixed-wing, mapped flight in both obstacle
modes).  ``cuda`` cases (each decides in its body whether a card exists):
the graphed serving solve, bridge head, 20-step whole-body episodes in
every mode, the pick_weight branches (a payload, the object, contact), the
drone episode, the arm episode and the 20-step scenario episodes bit-equal
to their eager calls, the launch counters counting replays, one
graph per argument structure, a capture that fails raising.  This file
imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py -m cuda
"""

import dataclasses

import pytest
import torch

from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.parallel.multihost import tree_map
from quadrotor_manipulator_mppi_tpu_torch.models import kinova
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr
from quadrotor_manipulator_mppi_tpu_torch.scenarios import solvers as scenarios
from quadrotor_manipulator_mppi_tpu_torch.sim import arm_loop
from quadrotor_manipulator_mppi_tpu_torch.sim import closed_loop as cl
from quadrotor_manipulator_mppi_tpu_torch.sim import contact as ct
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
from quadrotor_manipulator_mppi_tpu_torch.sim import graspable as gr
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.solver import arm, drone, mppi, serving
from quadrotor_manipulator_mppi_tpu_torch.solver import fixed_wing as fws
from quadrotor_manipulator_mppi_tpu_torch.solver import multirotor_mppi as mm
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb
from quadrotor_manipulator_mppi_tpu_torch.utils import graphs

K, H = 128, 10
SEEDS = torch.tensor([5, -7, 2**62 + 3])


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _small(params, k=K, h=H):
    return dataclasses.replace(params, mppi=dataclasses.replace(params.mppi, n_samples=k,
                                                                n_horizon=h))


PRESETS = {"attitude": lambda: _small(wb.WholeBodyMPPIParams(), 256, 12),
           "position": lambda: wb.position_mode_params(n_samples=K, n_horizon=H),
           "wrench": lambda: wb.wrench_mode_params(n_samples=256, n_horizon=12)}
# The 20-step episodes: (preset, loop configuration).
EPISODES = {"position_serving": ("position", dict(arm_coeffs_per_control=True,
                                                  plant_kernel=True)),
            "position_rnea": ("position", {}), "attitude": ("attitude", {}),
            "wrench": ("wrench", {})}


# ---------------------------------------------------------------------------
# CPU: a tensor solve index draws what the int draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 2**63 + 11, SEEDS])
@pytest.mark.parametrize("step", [0, 3, 2**32 + 4])
def test_philox_normals_tensor_step_equals_int(seed, step):
    want = sampling.philox_normals(seed, step, 64, 6, 11, sample_offset=16)
    got = sampling.philox_normals(seed, torch.tensor([step]), 64, 6, 11, sample_offset=16)
    assert torch.equal(got, want)


def test_philox_normals_per_scenario_steps():
    steps = torch.tensor([2, 9, 4])
    got = sampling.philox_normals(SEEDS, steps, 64, 6, 11)
    for b in range(3):
        want = sampling.philox_normals(int(SEEDS[b]), int(steps[b]), 64, 6, 11)
        assert torch.equal(got[b], want)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_philox_eps_tensor_step_equals_int(lead):
    params = wb.position_mode_params(n_samples=64, n_horizon=6)
    kc = wk.make_kernel_config(params)
    sc = torch.rand(lead + (wk.SC_LEN,))
    seeds = SEEDS if lead else sampling.philox_keys(5, "cpu")
    want = wk.philox_eps(kc, sc, seeds, 7, k_off=32)
    assert torch.equal(wk.philox_eps(kc, sc, seeds, torch.tensor([7]), k_off=32), want)
    if lead:
        per = wk.philox_eps(kc, sc, seeds, torch.tensor([7, 8, 7]), k_off=32)
        assert torch.equal(per[0], want[0]) and torch.equal(per[2], want[2])
        assert torch.equal(per[1], wk.philox_eps(kc, sc[1], seeds[1:2], 8, k_off=32))


@pytest.mark.parametrize("n_scenarios", [None, 3])
def test_plain_make_step_tensor_step_equals_int(n_scenarios):
    params = wb.position_mode_params(n_samples=64, n_horizon=8)
    step, init = wb.make_whole_body_solver(params, device="cpu", backend="torch",
                                           n_scenarios=n_scenarios)
    obs = wb.default_obs(device="cpu")
    if n_scenarios:
        obs = tree_map(lambda x: x.expand((n_scenarios,) + x.shape).clone(), obs)
    st_int = init(4)._replace(step=5)
    st_t = st_int._replace(step=torch.tensor([5]))
    for _ in range(2):
        out_i, st_int = step(st_int, obs)
        out_t, st_t = step(st_t, obs)
        assert torch.equal(out_i.u_seq, out_t.u_seq)
        assert torch.equal(st_int.u_prev, st_t.u_prev)
    assert st_int.step == 7 and st_t.step.tolist() == [7]


def test_wb_cost_plain_tensor_step_equals_int():
    params = wb.position_mode_params(n_samples=64, n_horizon=6)
    kc = wk.make_kernel_config(params)
    obs = wb.default_obs(device="cpu")
    sc = wk.pack_scalars(obs, mppi._diag_sigma(params.mppi))
    u_prev = torch.zeros(6, 11)
    keys = sampling.philox_keys(3, "cpu")
    want = wk.wb_cost(kc, sc, u_prev, None, keys, 11)
    got = wk.wb_cost(kc, sc, u_prev, None, keys, torch.tensor([11]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_step_tensor():
    t = torch.tensor([3])
    assert sampling.step_tensor(t, "cpu") is t
    s = sampling.step_tensor(2**40, "cpu")
    assert s.dtype == torch.int64 and s.tolist() == [2**40]


# ---------------------------------------------------------------------------
# CPU: the tree helpers, and graph=True running eagerly
# ---------------------------------------------------------------------------

def test_tree_helpers():
    a = mppi.MPPIState(u_prev=torch.ones(2, 3), sigma=torch.ones(3), seed=torch.tensor([1]),
                       step=torch.tensor([0]))
    b = graphs.clone_tree(a)
    assert type(b) is mppi.MPPIState and b.u_prev is not a.u_prev
    assert graphs.shapes(a) == graphs.shapes(b)
    src = a._replace(u_prev=torch.full((2, 3), 4.0), step=torch.tensor([9]))
    graphs.copy_into(b, src)
    assert torch.equal(b.u_prev, src.u_prev) and b.step.tolist() == [9]
    assert torch.equal(a.u_prev, torch.ones(2, 3))  # the source tree is untouched
    with pytest.raises(TypeError, match="not a tensor tree"):
        graphs.copy_into({"x": torch.ones(1)}, {"x": torch.ones(1)})


def test_graphed_step_needs_a_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.GraphedStep(lambda: None, "cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.graphed(lambda x: x, "cpu")(torch.ones(2))


def test_every_kernel_wrapper_counts_replays():
    """Each ops.cuda module registers its wrappers' counters with the
    graph runner, so a replay adds to every kernel's count."""
    from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import drone_kernel as dk

    wrappers = (*wk.KERNEL_WRAPPERS, pk.plant_tick, *dk.KERNEL_WRAPPERS)
    assert len(wrappers) == 11
    assert all(w in graphs._COUNTED for w in wrappers)
    graphs.count_replays(pk.plant_tick)  # registering twice keeps one entry
    assert graphs._COUNTED.count(pk.plant_tick) == 1


def test_packed_step_graph_flag_on_cpu_runs_eagerly():
    params = PRESETS["position"]()
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device="cpu"))
    calls = [serving.make_packed_step(params, device="cpu", graph=g) for g in (True, False)]
    carries = [pinit(2) for _, pinit in calls]
    for _ in range(3):
        outs = []
        for i, (pstep, _) in enumerate(calls):
            out, carries[i] = pstep(carries[i], obs_vec, target_vec)
            outs.append(out)
        assert torch.equal(*outs)
    assert torch.equal(carries[0].u_prev, carries[1].u_prev)
    assert carries[0].step.tolist() == [3] and carries[0].seed.tolist() == [2]


def test_bridge_step_graph_flag_on_cpu_runs_eagerly():
    params = wb.position_mode_params(n_samples=64, n_horizon=8)
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device="cpu"))
    (b1, i1), (b2, i2) = (serving.make_bridge_step(params, device="cpu", graph=g)
                          for g in (True, False))
    r1, c1 = b1(i1(4), obs_vec, target_vec)
    r2, c2 = b2(i2(4), obs_vec, target_vec)
    assert torch.equal(r1, r2) and torch.equal(c1.u_prev, c2.u_prev)


def test_episode_graph_flag_on_cpu_runs_eagerly():
    params = wb.position_mode_params(n_samples=64, n_horizon=8)
    cfg = wbl.WholeBodyLoopConfig(arm_coeffs_per_control=True, plant_kernel=True)
    runs = [wbl.make_whole_body_episode(params, cfg=cfg, n_control_steps=4, device="cpu",
                                        low_k_guard="off", graph=g) for g in (True, False)]
    _, init = wb.make_whole_body_solver(params, device="cpu")
    obs = wb.default_obs(device="cpu")
    outs = [run(wbl.init_plant(params.model.vehicle, device="cpu"), init(1), obs.ee_target,
                obs.base_target) for run in runs]
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert outs[0][0][1].step == 4  # the eager loop keeps an int solve index


def drone_episode(dev, n, graph, k=64):
    """The drone waypoint episode (``make_drone_solver`` through
    ``make_episode``, backstepping) at K=``k``, and its start."""
    params = drone.DroneMPPIParams(mppi=dataclasses.replace(drone.DroneMPPIParams().mppi,
                                                            n_samples=k))
    step, init = drone.make_drone_solver(params, device=dev)
    cfg, veh = cl.LoopConfig(controller="backstepping"), mr.MultirotorParams()
    target = torch.tensor(drone.DEFAULT_TARGET, device=dev)
    run = cl.make_episode(cfg, veh, fc.FlightGains(), step,
                          make_obs=lambda p: drone.DroneObs(x=p.pos, v=p.vel, target=target),
                          setpoint_of=lambda out, p: fc.hover_setpoint(out.xdes),
                          n_control_steps=n, graph=graph)
    return run, cl.init_loop_state(cfg, veh, init(3), pos=(0.0, 0.0, 2.0), device=dev)


def arm_episode(dev, n, graph, phase2=False):
    """The arm node at K=64, H=16 (torque limits x10), from rest in phase 1
    or from home in phase 2, and its start."""
    params = arm.ArmMPPIParams(mppi=mppi.MPPIConfig(n_samples=64, n_horizon=16))
    _, init = arm.make_arm_solver(params, device=dev)
    run = arm_loop.make_arm_episode(arm_loop.ArmLoopConfig(torque_limit_scale=10.0), params,
                                    n_control_steps=n, device=dev, graph=graph)
    start = arm_loop.init_arm_loop(init(4), q0=kinova.Q_HOME if phase2 else None, device=dev)
    return run, start._replace(phase2=torch.full((), phase2, device=dev))


def test_drone_episode_graph_flag_on_cpu_runs_eagerly():
    outs = [run(start) for run, start in (drone_episode("cpu", 4, g) for g in (True, False))]
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert outs[0][0].solver.step == 4  # the eager loop keeps an int solve index


@pytest.mark.parametrize("phase2", [False, True])
def test_arm_episode_graph_flag_on_cpu_runs_eagerly(phase2):
    outs = [run(start) for run, start in (arm_episode("cpu", 4, g, phase2) for g in (True, False))]
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert outs[0][0].solver.step.tolist() == [4 if phase2 else 0]


# The scenario episodes: (run, start) of n steps at small K, graphed or not.
SCENARIOS = {
    "whole_body": lambda dev, n, g: scenarios.whole_body_episode(
        _small(wb.position_mode_params(), 128, 10), n, dev, g),
    "multirotor": lambda dev, n, g: scenarios.multirotor_episode(
        _small(mm.MultirotorMPPIParams(), 128, 30), (1.0, 2.0, 3.4), n, dev, g),
    "fixed_wing": lambda dev, n, g: scenarios.fixed_wing_episode(
        _small(fws.FwMPPIParams(), 128, 40), n, dev, g),
    "mapped_spheres": lambda dev, n, g: scenarios.mapped_flight_episode(n, dev, 128, "spheres",
                                                                        g),
    "mapped_esdf": lambda dev, n, g: scenarios.mapped_flight_episode(n, dev, 128, "esdf", g),
}


def _scenario_runs(case, dev, n):
    """The final carries and logs of the graphed and the eager episode."""
    outs = []
    for g in (True, False):
        run, start = SCENARIOS[case](dev, n, g)
        outs.append(run(start(2)))
    return outs


def _trees_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_trees_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_scenario_episode_graph_flag_on_cpu_runs_eagerly(case):
    (fg, lg), (fe, le) = _scenario_runs(case, "cpu", 3)
    assert _trees_equal(lg, le) and _trees_equal(fg, fe)
    assert all(x.shape[0] == 3 for x in lg)


def test_a_number_in_the_carry_is_refused():
    """A graph freezes a Python number of its carry: ``run_episode`` names
    the field and refuses it before a capture."""
    _, start = drone_episode("cpu", 2, True)
    graphs.require_tensors(start._replace(solver=mppi.device_counters(start.solver, "cpu")),
                           "the loop state")
    with pytest.raises(TypeError, match=r"the loop state\.solver\.seed is a int"):
        graphs.require_tensors(start, "the loop state")
    with pytest.raises(TypeError, match=r"carry\.1\.yaw is a float"):
        graphs.require_tensors((start.plant, start.setpoint._replace(yaw=0.0)), "carry")


# ---------------------------------------------------------------------------
# cuda: graphed = eager, bit for bit; counters; a failed capture raises
# ---------------------------------------------------------------------------

def _serve(pstep, pinit, vecs, n):
    carry, outs = pinit(0), []
    for _ in range(n):
        out, carry = pstep(carry, *vecs)
        outs.append(out)
    return outs, carry.u_prev.clone(), carry.step.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(PRESETS))
def test_graphed_serving_solve_bit_equal_to_eager(mode):
    dev = _card()
    params = PRESETS[mode]()
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    runs = [_serve(*serving.make_packed_step(params, device=dev, low_k_guard="off", graph=g),
                   (obs_vec, target_vec), 12) for g in (True, False)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert torch.equal(runs[0][1], runs[1][1]) and runs[0][2].tolist() == [12]


@pytest.mark.cuda
def test_graphed_serving_solve_explicit_noise_and_donation():
    dev = _card()
    params = PRESETS["position"]()
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    (g, gi), (e, ei) = (serving.make_packed_step(params, device=dev, graph=x)
                        for x in (True, False))
    z = torch.randn(K, H, wk.A_TOTAL, device=dev)
    cg, ce = gi(3), ei(3)
    out_g, cg2 = g(cg, obs_vec, target_vec, z)
    out_e, ce2 = e(ce, obs_vec, target_vec, z)
    assert torch.equal(out_g, out_e) and torch.equal(cg2.u_prev, ce2.u_prev)
    kept = out_g.clone()
    out_g2, cg3 = g(cg2, obs_vec, target_vec, z)  # the returned carry is the graph's own
    assert cg3.u_prev is cg2.u_prev and torch.equal(out_g, kept)  # the reply is the caller's
    out_e2, _ = e(ce2, obs_vec, target_vec, z)
    assert torch.equal(out_g2, out_e2)


@pytest.mark.cuda
def test_graphed_bridge_head_bit_equal_to_eager():
    dev = _card()
    params = wb.position_mode_params(n_samples=K, n_horizon=H)
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    runs = [_serve(*serving.make_bridge_step(params, device=dev, graph=g),
                   (obs_vec, target_vec), 8) for g in (True, False)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EPISODES))
def test_graphed_episode_bit_equal_to_eager(case):
    dev = _card()
    mode, loop = EPISODES[case]
    params = PRESETS[mode]()
    _, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off")
    obs = wb.default_obs(device=dev)
    outs = []
    for g in (True, False):
        run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**loop),
                                          n_control_steps=20, device=dev, low_k_guard="off",
                                          graph=g)
        outs.append(run(wbl.init_plant(params.model.vehicle, device=dev), init(3),
                        obs.ee_target, obs.base_target))
    torch.cuda.synchronize()
    (fg, lg), (fe, le) = outs
    for name, a, b in zip(lg._fields, lg, le):
        assert torch.equal(a, b), name
    assert torch.equal(pk.pack_plant(fg[0]), pk.pack_plant(fe[0]))
    assert torch.equal(fg[1].u_prev, fe[1].u_prev) and fg[1].step.tolist() == [20]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["position_serving", "attitude"])
def test_graphed_fleet_bit_equal_to_eager(case):
    """A fleet of 3 (batched solves and plant, batched SPD solves through
    triangular solves) replayed from one captured control step."""
    dev = _card()
    mode, loop = EPISODES[case]
    params = PRESETS[mode]()
    starts = wbl.fleet_starts(params, 3, seed=2, device=dev)
    outs = []
    for g in (True, False):
        run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**loop),
                                          n_control_steps=10, device=dev, low_k_guard="off",
                                          n_scenarios=3, graph=g)
        outs.append(run(*starts))
    torch.cuda.synchronize()
    (fg, lg), (fe, le) = outs
    assert lg.ee_err.shape == (3, 10)
    for name, a, b in zip(lg._fields, lg, le):
        assert torch.equal(a, b), name
    assert torch.equal(pk.pack_plant(fg[0]), pk.pack_plant(fe[0]))


@pytest.mark.cuda
def test_graphed_drone_episode_bit_equal_to_eager():
    dev = _card()
    (fg, lg), (fe, le) = (run(start) for run, start in
                          (drone_episode(dev, 30, g, k=1000) for g in (True, False)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert all(torch.equal(a, b) for a, b in zip(fg.plant, fe.plant))
    assert torch.equal(fg.solver.u_prev, fe.solver.u_prev) and fg.solver.step.tolist() == [30]


@pytest.mark.cuda
@pytest.mark.parametrize("phase2", [False, True])
def test_graphed_arm_episode_bit_equal_to_eager(phase2):
    dev = _card()
    (fg, lg), (fe, le) = (run(start) for run, start in
                          (arm_episode(dev, 20, g, phase2) for g in (True, False)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    for name, a, b in zip(fg._fields[:-1], fg[:-1], fe[:-1]):
        assert torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip(fg.solver, fe.solver))


# The pick_weight branches: (loop configuration, object and contact).
PICK = {"payload_serving": (dict(payload_mass=0.5, plant_arm_lump=5.54,
                                 arm_coeffs_per_control=True, plant_kernel=True), False),
        "payload_object_contact": (dict(payload_mass=0.5, plant_arm_lump=5.54), True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PICK))
def test_graphed_pick_episode_bit_equal_to_eager(case):
    dev = _card()
    loop, with_object = PICK[case]
    params = PRESETS["position"]()
    _, init = wb.make_whole_body_solver(params, device=dev)
    obs = wb.default_obs(device=dev)
    plant = wbl.init_plant(params.model.vehicle, device=dev)
    ee, _ = wbl.chain_mod.forward_kinematics_posquat(params.model.chain(), plant.q,
                                                     plant.base.pos, plant.base.quat)
    kw, args = {}, []
    if with_object:
        obj_pos = (ee - torch.tensor([0.0, 0.0, 0.025], device=dev)).tolist()
        kw = dict(graspable=gr.GraspableParams(stand_center_xy=tuple(obj_pos[:2]),
                                               stand_top_z=obj_pos[2] - 0.04),
                  contact=ct.ContactParams(world=ct.WorldPrimitives(
                      spheres=((obj_pos[0], obj_pos[1], obj_pos[2] - 0.08, 0.08),))))
        args = [gr.init_graspable(kw["graspable"], pos=obj_pos, device=dev)]
    outs = []
    for g in (True, False):
        run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**loop),
                                          n_control_steps=12, device=dev, graph=g, **kw)
        outs.append(run(plant, init(3), obs.ee_target, obs.base_target, *args))
    torch.cuda.synchronize()
    (fg, lg), (fe, le) = outs
    for name, a, b in zip(lg._fields, lg, le):
        assert torch.equal(a, b), name
    assert torch.equal(pk.pack_plant(fg[0]), pk.pack_plant(fe[0]))
    if with_object:
        assert all(torch.equal(a, b) for a, b in zip(fg[4], fe[4]))
        assert (lg.obj_pos[-1] - lg.obj_pos[0]).abs().max().item() > 0.0  # the palm pushed


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_graphed_scenario_episode_bit_equal_to_eager(case):
    """20 control steps: the logs and every field of the final carry (the
    grid, the solver state and the noise counters included)."""
    dev = _card()
    (fg, lg), (fe, le) = _scenario_runs(case, dev, 20)
    torch.cuda.synchronize()
    assert _trees_equal(lg, le) and _trees_equal(fg, fe)
    assert all(bool(torch.isfinite(x).all()) for x in lg)


@pytest.mark.cuda
def test_launch_counters_count_replays():
    dev = _card()
    params = PRESETS["position"]()
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    pstep, pinit = serving.make_packed_step(params, device=dev)
    carry = pinit(0)
    _, carry = pstep(carry, obs_vec, target_vec)  # warm-up launches and the capture
    before = (wk.wb_cost.launches, wk.wb_update.launches)
    for _ in range(7):
        _, carry = pstep(carry, obs_vec, target_vec)
    assert (wk.wb_cost.launches - before[0], wk.wb_update.launches - before[1]) == (7, 7)

    kc = wk.make_kernel_config(params)
    sc = wk.pack_scalars(wb.default_obs(device=dev), mppi._diag_sigma(params.mppi, device=dev))
    u_prev, keys = torch.zeros(H, 11, device=dev), sampling.philox_keys(1, dev)
    steps = torch.zeros(1, dtype=torch.int64, device=dev)

    def fn():
        out = wk.wb_cost(kc, sc, u_prev, None, keys, steps)
        steps.add_(1)
        return out[0]

    n0 = wk.wb_cost.launches
    g = graphs.GraphedStep(fn, dev, warmup=1)
    assert wk.wb_cost.launches == n0 + 1  # the warm-up call; the capture launches nothing
    assert g.launches_per_replay == {"wb_cost": 1}
    first = g.replay().clone()
    for _ in range(3):
        second = g.replay()
    torch.cuda.synchronize()
    assert wk.wb_cost.launches == n0 + 5 and steps.tolist() == [5]
    assert not torch.equal(first, second)  # the counter moved: new noise per replay
    want = wk.wb_cost_plain(kc, sc, u_prev, None, keys, 4)[0]
    assert (second - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_kernels_read_the_solve_index_from_the_card():
    """Rows 1 and 4-6 draw the same words from a device solve index as
    from an int (which the wrapper writes to the card), and a batch with
    one index per scenario equals its scenarios launched alone."""
    dev = _card()
    params = PRESETS["position"]()
    kc = wk.make_kernel_config(params)
    sigma = mppi._diag_sigma(params.mppi, device=dev)
    sc = wk.pack_scalars(wb.default_obs(device=dev), sigma)
    u_prev, keys = torch.zeros(H, 11, device=dev), sampling.philox_keys(9, dev)
    n = torch.tensor([6], device=dev)
    for variant in (wk.wb_cost, wk.wb_cost_nospill):
        got = variant(kc, sc, u_prev, None, keys, n) if variant is wk.wb_cost else \
            variant(kc, sc, u_prev, keys, n)
        want = variant(kc, sc, u_prev, None, keys, 6) if variant is wk.wb_cost else \
            variant(kc, sc, u_prev, keys, 6)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    s, m, e = wk.wb_cost_nospill(kc, sc, u_prev, keys, n)
    se = wk.softmin_normalizers(kc, m, e)
    assert all(torch.equal(a, b) for a, b in zip(wk.wb_update_regen(kc, sc, s, m, e, keys, n),
                                                 wk.wb_update_regen(kc, sc, s, m, e, keys, 6)))
    assert all(torch.equal(a, b) for a, b in zip(wk.wb_update_shard_regen(kc, sc, s, se, keys, n),
                                                 wk.wb_update_shard_regen(kc, sc, s, se, keys, 6)))
    scs, ups = sc.expand(3, -1).contiguous(), u_prev.expand(3, H, 11).contiguous()
    batch = wk.wb_cost(kc, scs, ups, None, SEEDS.to(dev), torch.tensor([4, 7, 5], device=dev))
    for b, step in enumerate((4, 7, 5)):
        one = wk.wb_cost(kc, sc, u_prev, None, SEEDS[b:b + 1].to(dev), step)
        assert all(torch.equal(x[b], y) for x, y in zip(batch, one))


@pytest.mark.cuda
def test_graphed_keys_graphs_by_argument_structure():
    """One capture per argument structure: a call copies its arguments into
    the static buffers (a buffer passed back in is not copied), and
    arguments of another shape get a graph of their own."""
    dev = _card()

    def fn(x, y):
        x.mul_(2.0)
        return x + y

    load = graphs.graphed(fn, dev, warmup=1)
    g = load(torch.ones(3, device=dev), torch.zeros(3, device=dev))
    assert g.replay().tolist() == [2.0] * 3
    assert load(g.args[0], torch.ones(3, device=dev)) is g  # the static x, donated
    assert g.replay().tolist() == [5.0] * 3
    g2 = load(torch.ones(4, device=dev), torch.zeros(4, device=dev))
    assert g2 is not g and g2.replay().tolist() == [2.0] * 4
    with pytest.raises(ValueError, match="captured for"):
        g.load(torch.ones(4, device=dev), torch.zeros(4, device=dev))


@pytest.mark.cuda
def test_a_failed_capture_raises():
    dev = _card()
    x = torch.ones(4, device=dev)

    def host_sync():
        return torch.tensor([(x * 2).sum().item()], device=dev)  # waits for the card

    with pytest.raises(RuntimeError, match="CUDA graph capture failed"):
        graphs.GraphedStep(host_sync, dev, warmup=1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x * 2).all())  # the card still works after the failure
