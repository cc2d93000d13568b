"""On-card cases of the port: each CUDA kernel against its plain PyTorch
version at a small size.  Marked ``cuda``; each case decides in its body
whether a card exists and skips otherwise.  This file imports neither JAX
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import drone_kernel as dk
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.parallel.multihost import tree_map
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.solver import drone, mppi, serving
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb

K, H = 512, 16
PRESETS = {"attitude": wb.WholeBodyMPPIParams, "position": wb.position_mode_params,
           "wrench": wb.wrench_mode_params}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _params(mode):
    make = PRESETS[mode]
    if mode == "attitude":
        import dataclasses

        p = make()
        return dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, n_samples=K, n_horizon=H))
    return make(n_samples=K, n_horizon=H)


def _inputs(params, dev, seed=0):
    _, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off")
    state = init(seed)
    obs = wb.default_obs(device=dev)
    sigma = state.sigma * params.mppi.sigma_scale_fn(obs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    z = torch.randn((K, H, wk.A_TOTAL), generator=gen, device=dev)
    eps = (z * sigma).permute(2, 1, 0).contiguous()
    return state, obs, z, wk.pack_scalars(obs, sigma), eps


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(PRESETS))
def test_wb_cost_matches_plain(mode):
    dev = _card()
    params = _params(mode)
    kc = wk.make_kernel_config(params)
    state, _, _, sc, eps = _inputs(params, dev)
    s_k, m_k, e_k, _ = wk.wb_cost(kc, sc, state.u_prev, eps)
    s_p, m_p, e_p, _ = wk.wb_cost_plain(kc, sc, state.u_prev, eps)
    torch.cuda.synchronize()
    # recurrence vs operator form: float32 rounding only
    assert (s_k - s_p).abs().max().item() <= 1e-4 * max(1.0, s_p.abs().max().item())
    torch.testing.assert_close(m_k, m_p, rtol=1e-4, atol=0.0)


@pytest.mark.cuda
def test_wb_cost_reads_forty_obstacles():
    """40 sphere obstacles (more than the 16 the parameter struct once
    carried) from the device buffer: S against the plain version, which
    the obstacles move."""
    import dataclasses

    import numpy as np

    dev = _card()
    gen = np.random.default_rng(40)
    base = _params("position")
    centers = np.asarray([0.3, 0.1, 1.8]) + gen.uniform(-0.4, 0.4, (40, 3))
    params = dataclasses.replace(base, cost=dataclasses.replace(
        base.cost, obstacle_weight=100.0, obstacle_centers=tuple(map(tuple, centers.tolist())),
        obstacle_radii=tuple(gen.uniform(0.05, 0.3, 40).tolist())))
    kc = wk.make_kernel_config(params)
    assert kc.struct.n_obs == 40
    state, _, _, sc, eps = _inputs(params, dev)
    s_k = wk.wb_cost(kc, sc, state.u_prev, eps)[0]
    s_p = wk.wb_cost_plain(kc, sc, state.u_prev, eps)[0]
    s_free = wk.wb_cost_plain(wk.make_kernel_config(base), sc, state.u_prev, eps)[0]
    torch.cuda.synchronize()
    assert (s_k - s_p).abs().max().item() <= 1e-4 * max(1.0, s_p.abs().max().item())
    assert (s_p - s_free).abs().max().item() > 1.0  # the spheres cost something


@pytest.mark.cuda
def test_wb_update_matches_plain():
    dev = _card()
    params = _params("position")
    kc = wk.make_kernel_config(params)
    state, _, _, sc, eps = _inputs(params, dev)
    s, m, e, _ = wk.wb_cost(kc, sc, state.u_prev, eps)
    du_k, m2_k = wk.wb_update(kc, eps, s, m, e)
    du_p, m2_p = wk.wb_update_plain(kc, eps, s, m, e)
    torch.cuda.synchronize()
    for got, want in ((du_k, du_p), (m2_k, m2_p)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    # deterministic: no atomics, fixed reduction order
    du_again, _ = wk.wb_update(kc, eps, s, m, e)
    assert torch.equal(du_again, du_k)


@pytest.mark.cuda
def test_philox_spill_matches_plain():
    dev = _card()
    params = _params("attitude")
    kc = wk.make_kernel_config(params)
    state, _, _, sc, _ = _inputs(params, dev)
    keys = wk.philox_keys(2**40 + 3, dev)
    _, _, _, eps = wk.wb_cost(kc, sc, state.u_prev, None, keys, step=9)
    z = sampling.philox_normals(2**40 + 3, 9, K, H, wk.A_TOTAL, dev)
    sigma = sc[wk.SC_SIGMA:wk.SC_SIGMA + wk.A_TOTAL].view(-1, 1, 1)
    assert (eps / sigma - z).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(PRESETS))
def test_kernel_step_matches_plain_pipeline(mode):
    dev = _card()
    params = _params(mode)
    state, obs, z, _, _ = _inputs(params, dev)
    step_k = wk.make_whole_body_cuda_step(params, dev)
    step_p = mppi.make_step(params.mppi, *wb.rollout_cost_fns(params))
    u_k, st_k = step_k(state, obs, z)
    u_p, st_p = step_p(state, obs, z)
    torch.testing.assert_close(u_k, u_p, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st_k.u_prev, st_p.u_prev, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_packed_serving_launches_both_kernels():
    dev = _card()
    pstep, pinit = serving.make_packed_step(_params("position"), device=dev)
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    _, carry = pstep(pinit(0), obs_vec, target_vec)  # the capture (its warm-up calls launch)
    n_cost, n_update = wk.wb_cost.launches, wk.wb_update.launches
    for _ in range(3):
        out, carry = pstep(carry, obs_vec, target_vec)
    assert (wk.wb_cost.launches - n_cost, wk.wb_update.launches - n_update) == (3, 3)
    assert out.shape == (serving.OUT_SIZE,) and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 5, 64, 1024])
def test_plant_tick_matches_plain(rows):
    """Eight lanes per row, four rows per warp: one row, a part-filled
    warp (3, 5), whole blocks (64) and the fleet size (1024); bit-equal on
    a rerun, each row equal to its own one-row launch."""
    dev = _card()
    model = wb.position_mode_params().model
    pc = pk.make_plant_config(model.vehicle, fc.FlightGains(), model.chain(),
                              extra_mass=model.arm_mass_lump)
    state, dyn, cmd, tau = pk.sample_rows(model.vehicle, model.chain(), model.inertials(), rows,
                                          seed=rows, device=dev)
    n0 = pk.plant_tick.launches
    got = pk.plant_tick(pc, state, dyn, cmd, tau)
    again = pk.plant_tick(pc, state, dyn, cmd, tau)
    want = pk.plant_tick_plain(pc, state, dyn, cmd, tau)
    torch.cuda.synchronize()
    assert pk.plant_tick.launches == n0 + 2
    assert got.shape == (rows, pk.STATE_SIZE)
    assert torch.equal(got, again)
    # atan2f/asinf against torch.atan2/asin on the same card; float32 rounding only
    assert (got - want).abs().max().item() <= 1e-4
    for b in {0, rows // 2, rows - 1}:
        one = pk.plant_tick(pc, state[b].contiguous(), dyn[b].contiguous(),
                            cmd[b].contiguous(), tau[b].contiguous())
        assert torch.equal(one, got[b])


@pytest.mark.cuda
def test_serving_episode_kernel_matches_plain_physics():
    dev = _card()
    n = 20
    params = wb.position_mode_params(n_samples=K, n_horizon=H)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    z = torch.randn((n, K, H, wk.A_TOTAL), generator=gen, device=dev)
    obs = wb.default_obs(device=dev)
    logs = {}
    for use_kernel in (True, False):
        cfg = wbl.WholeBodyLoopConfig(arm_coeffs_per_control=True, plant_kernel=use_kernel)
        run = wbl.make_whole_body_episode(params, cfg=cfg, n_control_steps=n, device=dev)
        _, init = wb.make_whole_body_solver(params, device=dev)
        args = (wbl.init_plant(params.model.vehicle, device=dev), init(0), obs.ee_target,
                obs.base_target)
        run(*args, z=z)  # the capture (its warm-up calls launch), then a first run
        n0 = pk.plant_tick.launches
        final, logs[use_kernel] = run(*args, z=z)
        assert pk.plant_tick.launches - n0 == (n if use_kernel else 0)
        assert all(bool(torch.isfinite(f).all()) for f in logs[use_kernel])
    torch.testing.assert_close(logs[True].ee_err, logs[False].ee_err, rtol=0, atol=5e-3)
    torch.testing.assert_close(logs[True].base_pos, logs[False].base_pos, rtol=0, atol=5e-3)


def _rel(got, want) -> float:
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("row", [4, 5, 6, 7])
def test_new_variants_match_plain(row):
    """Rows 4-7 against their plain versions at a sample offset, each
    launching its kernel once."""
    dev = _card()
    params = _params("attitude")
    kc = wk.make_kernel_config(params)
    state, _, _, sc, _ = _inputs(params, dev)
    u_prev, seed, step, k_off = state.u_prev, wk.philox_keys(2**33 + 1, dev), 4, 512
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, seed, step, k_off)
    se = wk.softmin_normalizers(kc, m, e).contiguous()
    kernel, run, plain = {
        4: (wk.wb_cost_nospill, lambda f: f(kc, sc, u_prev, seed, step, k_off),
            wk.wb_cost_nospill_plain),
        5: (wk.wb_update_regen, lambda f: f(kc, sc, s, m, e, seed, step, k_off),
            wk.wb_update_regen_plain),
        6: (wk.wb_update_shard_regen, lambda f: f(kc, sc, s, se, seed, step, k_off),
            wk.wb_update_shard_regen_plain),
        7: (wk.wb_update_shard, lambda f: f(kc, eps, s, se), wk.wb_update_shard_plain),
    }[row]
    n0 = kernel.launches
    got, want = run(kernel), run(plain)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    # (S, block minima): recurrence vs operator form; (du, m2): order only
    tol = 1e-4 if row == 4 else 1e-5
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) <= tol
    if row == 4:  # the same draw as the spill variant: identical costs
        assert torch.equal(got[0], s)


def _three_scenarios(dev):
    """Three observations apart in every field but the (unit) target
    quaternion."""
    obs = tree_map(lambda x: x if x.shape[-1] == 4 else torch.stack([x, x + 0.02, x - 0.03]),
                   wb.default_obs(device=dev))
    return obs._replace(ee_target=obs.ee_target._replace(
        quat=obs.ee_target.quat.expand(3, 4).contiguous()))


# wb_update's four variants by PERF.md row: (wrapper, plain version).
UPDATES = {3: (wk.wb_update, wk.wb_update_plain), 5: (wk.wb_update_regen, wk.wb_update_regen_plain),
           6: (wk.wb_update_shard_regen, wk.wb_update_shard_regen_plain),
           7: (wk.wb_update_shard, wk.wb_update_shard_plain)}
# (K, H, B): one load step per thread; several (8 samples per thread and
# row); fewer samples than threads; a tail block at R = 4 and 8 (550 rows)
# in a batch of 3; 176 rows; 143 rows, a tail block at every R > 1.
UPDATE_CASES = [(512, 16, 1), (8192, 16, 1), (64, 50, 1), (512, 50, 3), (512, 13, 1)]


def _update_inputs(dev, k, h, b, step=3, k_off=64):
    """Pass 1's spilled noise, costs and partials at (K, H, B) with a
    sample offset, the global (rho, eta), and each variant's arguments."""
    params = wb.position_mode_params(n_samples=k, n_horizon=h)
    kc = wk.make_kernel_config(params)
    _, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off",
                                        n_scenarios=None if b == 1 else b)
    state = init(9)
    obs = wb.default_obs(device=dev) if b == 1 else _three_scenarios(dev)
    sc = wk.pack_scalars(obs, state.sigma)
    seeds = wk.philox_keys(state.seed, dev)
    s, m, e, eps = wk.wb_cost(kc, sc, state.u_prev, None, seeds, step, k_off)
    se = wk.softmin_normalizers(kc, m, e).contiguous()
    args = {3: (kc, eps, s, m, e), 5: (kc, sc, s, m, e, seeds, step, k_off),
            6: (kc, sc, s, se, seeds, step, k_off), 7: (kc, eps, s, se)}
    launch = {3: dict(eps=eps, m_part=m, e_part=e),
              5: dict(m_part=m, e_part=e, sc=sc, seeds=seeds, step=step, k_off=k_off),
              6: dict(se=se, sc=sc, seeds=seeds, step=step, k_off=k_off),
              7: dict(eps=eps, se=se)}
    return kc, s, args, launch


@pytest.mark.cuda
@pytest.mark.parametrize("k,h,b", UPDATE_CASES)
@pytest.mark.parametrize("row", sorted(UPDATES))
def test_wb_update_variant_matches_plain_and_reruns_bit_equal(row, k, h, b):
    """Each wb_update variant against its plain version (du and m2 within
    1e-5 of the largest entry: summation order only), one launch per call,
    bit-equal on a rerun and at every rows-per-block R."""
    dev = _card()
    kc, s, args, launch = _update_inputs(dev, k, h, b)
    wrapper, plain = UPDATES[row]
    n0 = wrapper.launches
    got, want = wrapper(*args[row]), plain(*args[row])
    again = wrapper(*args[row])
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 2
    assert got[0].shape == s.shape[:-1] + (wk.A_TOTAL * h,)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for r in wk.UPDATE_ROWS:
        other = wk._launch_update(kc, wrapper.__name__, s, rows_per_block=r, **launch[row])
        torch.cuda.synchronize()
        assert all(torch.equal(g, o) for g, o in zip(got, other)), r


@pytest.mark.cuda
@pytest.mark.parametrize("k,h,b", [(8192, 16, 1), (512, 50, 3)])
def test_wb_update_regen_equals_read(k, h, b):
    """Row 5 on the noise drawn again against row 3 on its spill, on the
    same costs: each thread adds the same terms in the same order."""
    dev = _card()
    _, _, args, _ = _update_inputs(dev, k, h, b)
    du3, m2_3 = wk.wb_update(*args[3])
    du5, m2_5 = wk.wb_update_regen(*args[5])
    torch.cuda.synchronize()
    assert (du5 - du3).abs().max().item() <= 1e-6 * du3.abs().max().item()
    assert (m2_5 - m2_3).abs().max().item() <= 1e-6 * m2_3.abs().max().item()


@pytest.mark.cuda
def test_batched_launch_matches_plain():
    dev = _card()
    params = _params("position")
    kc = wk.make_kernel_config(params)
    _, init = wb.make_whole_body_solver(params, device=dev, n_scenarios=3)
    state = init(5)
    obs = _three_scenarios(dev)
    sc = wk.pack_scalars(obs, state.sigma)
    n_cost, n_upd = wk.wb_cost.launches, wk.wb_update.launches
    s, m, e, eps = wk.wb_cost(kc, sc, state.u_prev, None, state.seed, 1)
    du, m2 = wk.wb_update(kc, eps, s, m, e)
    assert (wk.wb_cost.launches - n_cost, wk.wb_update.launches - n_upd) == (1, 1)
    s_p, _, _, eps_p = wk.wb_cost_plain(kc, sc, state.u_prev, None, state.seed, 1)
    du_p, m2_p = wk.wb_update_plain(kc, eps, s, m, e)
    torch.cuda.synchronize()
    assert s.shape == (3, K) and du.shape == (3, wk.A_TOTAL * H)
    assert _rel(s, s_p) <= 1e-4 and (eps - eps_p).abs().max().item() <= 1e-5
    assert _rel(du, du_p) <= 1e-5 and _rel(m2, m2_p) <= 1e-5


DRONE_KERNELS = ("drone_cost", "drone_update", "drone_cost_noise", "drone_update_noise")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1000, 1024])
@pytest.mark.parametrize("kernel", DRONE_KERNELS)
def test_drone_kernel_matches_plain(kernel, k):
    """Rows 9a-9d against their plain versions at the preset's H=32, each
    launching its kernel once; pass 2 on the same weights."""
    dev = _card()
    h, a = 32, 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    u_prev = torch.randn((h, a), generator=gen, device=dev)
    x0, v0 = torch.tensor([0.1, -0.2, 1.0], device=dev), torch.tensor([0.0, 0.3, 0.0], device=dev)
    target = torch.tensor([1.0, 2.0, 3.4], device=dev)
    keys = sampling.philox_keys(2**35 + k, dev)
    noise = 30.0 * torch.randn((k, h, a), generator=gen, device=dev)
    s = dk.drone_cost_noise_plain(u_prev, noise, x0, v0, target, 0.01, 100.0, 20.0)
    w = torch.softmax((s.min() - s) / 0.1, dim=0)
    args = {"drone_cost": (u_prev, x0, v0, target, keys, k, 0.01, 30.0, 100.0, 20.0),
            "drone_update": (w, keys, h, a, 30.0),
            "drone_cost_noise": (u_prev, noise, x0, v0, target, 0.01, 100.0, 20.0),
            "drone_update_noise": (noise, w)}[kernel]
    wrapper, plain = getattr(dk, kernel), getattr(dk, kernel + "_plain")
    n0 = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1 and got.shape == want.shape
    if "cost" in kernel:  # recurrence vs cumsum: float32 rounding only
        assert _rel(got, want) <= 1e-4
    else:  # summation order only
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_drone_solve_equals_the_presets_first_step():
    dev = _card()
    step, init = drone.make_drone_solver(device=dev)
    obs = drone.DroneObs(x=torch.zeros(3, device=dev), v=torch.zeros(3, device=dev),
                         target=torch.tensor(drone.DEFAULT_TARGET, device=dev))
    state = init(7)
    out, _ = step(state, obs)
    u = dk.solve_drone_cuda(state.u_prev, obs.x, obs.v, obs.target, 7, n_samples=1000)
    assert _rel(u, out.u_seq) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["attitude", "position"])
def test_nospill_step_equals_spill_step(mode):
    dev = _card()
    params = _params(mode)
    state, obs, _, _, _ = _inputs(params, dev)
    u = {}
    for spill in (True, False):
        step = wk.make_whole_body_cuda_step(params, dev, noise_spill=spill)
        u[spill], _ = step(state, obs)
    assert _rel(u[False], u[True]) <= 1e-6


# wb_cost at chunk edges and partial chunks (H of 1, 7, 32, 33, 50, 100),
# every K of the main paths' kind (64; K_local=2048 at a sample offset;
# 4096) and B of 1 and 3: (H, K, k_off, B).
COST_CASES = [(1, 64, 0, 1), (7, 64, 0, 3), (32, 2048, 64, 1), (33, 64, 0, 3),
              (50, 4096, 0, 1), (50, 2048, 2048, 3), (100, 64, 0, 1)]
COST_VARIANTS = (1, 2, 0)  # wb_cost_launch: spill, no spill, explicit noise (reads the spill)


def _cost_inputs(dev, mode, h, k, b):
    p = PRESETS[mode]()
    import dataclasses

    params = dataclasses.replace(p, mppi=dataclasses.replace(
        p.mppi, n_samples=k, n_horizon=h, savgol_window=p.mppi.savgol_window if h >= 9 else 0))
    kc = wk.make_kernel_config(params)
    _, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off",
                                        n_scenarios=None if b == 1 else b)
    state = init(4)
    obs = wb.default_obs(device=dev) if b == 1 else _three_scenarios(dev)
    sigma = state.sigma
    if params.mppi.sigma_scale_fn is not None:
        sigma = sigma * params.mppi.sigma_scale_fn(obs)
    return kc, wk.pack_scalars(obs, sigma), state.u_prev, wk.philox_keys(state.seed, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("h,k,k_off,b", COST_CASES)
@pytest.mark.parametrize("mode", sorted(PRESETS))
def test_wb_cost_matches_plain_and_reruns_bit_equal(mode, h, k, k_off, b):
    """Each variant of wb_cost against the plain version (S within 1e-4:
    scans against the operator form), the spill bit-equal to philox_eps,
    the no-spill and explicit-noise costs bit-equal to the spill variant's,
    every launch bit-equal on a rerun, each scenario of a batch bit-equal
    to its unbatched launch; the wrappers launch once each."""
    dev = _card()
    kc, sc, u_prev, seeds = _cost_inputs(dev, mode, h, k, b)
    step = 7
    s_p, m_p, _, eps_p = wk.wb_cost_plain(kc, sc, u_prev, None, seeds, step, k_off)
    costs, spill = {}, None
    for variant in COST_VARIANTS:
        def launch():
            return wk._launch_cost(kc, "wb_cost", sc, u_prev, spill if variant == 0 else None,
                                   seeds if variant else None, step, k_off, variant)

        got, again = launch(), launch()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got[:3], again[:3])), variant
        assert _rel(got[0], s_p) <= 1e-4 and _rel(got[1], m_p) <= 1e-4, variant
        if variant == 1:
            assert torch.equal(got[3], eps_p) and torch.equal(again[3], got[3])
            spill = got[3]
        costs[variant] = got
    # the same draws in registers, or read back: the same bits
    assert torch.equal(costs[2][0], costs[1][0]) and torch.equal(costs[0][0], costs[1][0])
    if b > 1:
        for i in range(b):
            one = wk._launch_cost(kc, "wb_cost", sc[i], u_prev[i], None, seeds[i:i + 1], step,
                                  k_off, 1)
            assert all(torch.equal(x, y[i]) for x, y in zip(one, costs[1])), i
    n0, n4 = wk.wb_cost.launches, wk.wb_cost_nospill.launches
    s, _, _, eps = wk.wb_cost(kc, sc, u_prev, None, seeds, step, k_off)
    s4, _, _ = wk.wb_cost_nospill(kc, sc, u_prev, seeds, step, k_off)
    assert (wk.wb_cost.launches - n0, wk.wb_cost_nospill.launches - n4) == (1, 1)
    assert torch.equal(s, costs[1][0]) and torch.equal(s4, s) and torch.equal(eps, eps_p)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
def test_wb_cost_launches_at_the_longest_horizon(k):
    """At wk.max_horizon() each variant needs shared memory above the
    default 48 KB (the launcher opts in) and launches: S within 1e-4 of the
    plain version, the spill bit-equal to philox_eps."""
    dev = _card()
    h = wk.max_horizon()
    kc, sc, u_prev, seeds = _cost_inputs(dev, "attitude", h, k, 1)
    s_p, m_p, _, eps_p = wk.wb_cost_plain(kc, sc, u_prev, None, seeds, 3, 0)
    spill = None
    for variant in COST_VARIANTS:
        s, m, _, eps = wk._launch_cost(kc, "wb_cost", sc, u_prev, spill if variant == 0 else None,
                                       seeds if variant else None, 3, 0, variant)
        torch.cuda.synchronize()
        assert wk.cost_smem_bytes(h, variant) > 48 * 1024
        assert _rel(s, s_p) <= 1e-4 and _rel(m, m_p) <= 1e-4, variant
        if variant == 1:
            assert torch.equal(eps, eps_p)
            spill = eps


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_pass2_regenerates_the_spill_bit_for_bit(b):
    """Rows 5 and 6 draw the noise again: on the same costs they equal rows
    3 and 7 on wb_cost's spill, bit for bit, for one scenario and a batch."""
    dev = _card()
    kc, sc, u_prev, seeds = _cost_inputs(dev, "attitude", 50, 2048, b)
    step, k_off = 2, 2048
    s, m, e, eps = wk._launch_cost(kc, "wb_cost", sc, u_prev, None, seeds, step, k_off, 1)
    se = wk.softmin_normalizers(kc, m, e).contiguous()
    row3 = wk.wb_update(kc, eps, s, m, e)
    row5 = wk.wb_update_regen(kc, sc, s, m, e, seeds, step, k_off)
    row7 = wk.wb_update_shard(kc, eps, s, se)
    row6 = wk.wb_update_shard_regen(kc, sc, s, se, seeds, step, k_off)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(row3, row5))
    assert all(torch.equal(a, b) for a, b in zip(row7, row6))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1, 5, 32, 33, 100])
@pytest.mark.parametrize("k", [1, 1000, 1024])
def test_drone_cost_across_chunks_matches_plain(k, h):
    """Rows 9a and 9c (a warp per sample, the horizon across its lanes in
    chunks of 32) against their plain versions at one chunk, a partial
    chunk and several, any K; bit-equal on a rerun; one launch each."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(10 * k + h)
    u_prev = torch.randn((h, 3), generator=gen, device=dev)
    x0, v0 = torch.tensor([0.1, -0.2, 1.0], device=dev), torch.tensor([0.0, 0.3, 0.0], device=dev)
    target = torch.tensor([1.0, 2.0, 3.4], device=dev)
    keys = sampling.philox_keys(2**34 + k + h, dev)
    noise = 30.0 * torch.randn((k, h, 3), generator=gen, device=dev)
    for name, args in (("drone_cost", (u_prev, x0, v0, target, keys, k, 0.01, 30.0, 100.0, 20.0)),
                       ("drone_cost_noise", (u_prev, noise, x0, v0, target, 0.01, 100.0, 20.0))):
        wrapper, plain = getattr(dk, name), getattr(dk, name + "_plain")
        n0 = wrapper.launches
        got, again, want = wrapper(*args), wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 2 and got.shape == (k,)
        assert torch.equal(got, again)
        assert _rel(got, want) <= 1e-4, name


# drone_update's shapes: chip_smoke's sweep (DRONE_SIZES), then edges: one
# sample, a K that leaves the last chunk part-filled (33, 1000, 5000), H*A
# not a multiple of 32 (H = 5, 33), one 32-column tile (H = 5) with 2, 32
# and 157 chunks; one column per block at the preset's K and H = 33.
DRONE_UPDATE_CASES = [(1000, 32), (1024, 32), (4096, 32), (16384, 32), (16384, 100),
                      (1, 32), (33, 5), (33, 33), (1000, 5), (1000, 33), (5000, 5)]


def _drone_update_inputs(dev, k, h):
    gen = torch.Generator(device=dev)
    gen.manual_seed(7 * k + h)
    noise = 30.0 * torch.randn((k, h, 3), generator=gen, device=dev)
    w = torch.softmax(torch.randn(k, generator=gen, device=dev) * 3.0, dim=0)
    return noise, w, sampling.philox_keys(2**33 + 5 * k + h, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k,h", DRONE_UPDATE_CASES)
def test_drone_update_tiles_match_plain_and_rerun_bit_equal(k, h):
    """Rows 9b and 9d (column blocks by ``update_split``: one column and
    all K at small K, 32-column tiles with K split across blocks at large
    K) against their plain versions within 1e-5 of max|du| (summation
    order only), bit-equal on a rerun, one launch a call."""
    dev = _card()
    noise, w, keys = _drone_update_inputs(dev, k, h)
    for name, args in (("drone_update", (w, keys, h, 3, 30.0)),
                       ("drone_update_noise", (noise, w))):
        wrapper, plain = getattr(dk, name), getattr(dk, name + "_plain")
        n0 = wrapper.launches
        got, again, want = wrapper(*args), wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 2 and got.shape == (h, 3)
        assert torch.equal(got, again), name
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("k,h", [(40, 5), (200, 5), (33, 33), (96, 32)])
def test_drone_update_draw_equals_read_bit_for_bit(k, h):
    """The draw variant's du equals the read variant's on the noise it
    draws, bit for bit.  That noise is read back from the draw variant
    itself: with one-hot weights du is one sample's draws exactly."""
    dev = _card()
    _, w, keys = _drone_update_inputs(dev, k, h)
    eye = torch.eye(k, device=dev)
    drawn = torch.stack([dk.drone_update(eye[i].contiguous(), keys, h, 3, 30.0)
                         for i in range(k)])
    torch.testing.assert_close(drawn, dk.philox_noise(keys, k, h, 3, 30.0), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(dk.drone_update(w, keys, h, 3, 30.0),
                       dk.drone_update_noise(drawn.contiguous(), w))
