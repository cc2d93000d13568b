"""The port's scenario-batched solve and its no-spill kernel pair on the CPU.

A batch of B scenarios runs through one launch per pass (here: the
kernels' plain versions).  It must equal B unbatched port steps (the same
arithmetic, so up to float order), and ``jax.vmap`` of the JAX step with
each scenario's noise rebuilt from its key.  Rows 4+5 (no spill: pass 2
draws the noise again) must equal rows 1+3 (spill).  Also: the Philox
stream's global sample offset, the batched scalar pack and sigma
schedule, batched states from the JAX package's vmapped states, and the
C interface of the new variants, checked against the CUDA source.
"""

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.parallel.sharded import scenario_keys
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.parallel.multihost import tree_map
from quadrotor_manipulator_mppi_tpu_torch.parallel.sharded import scenario_seeds
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb
from quadrotor_manipulator_mppi_tpu_torch.solver.mppi import MPPIState

from torch_parity import (  # noqa: F401
    N, obs_to_port, perturbed_obs, shared_z, small, to_port, torch_one_thread,
)

B, K, H = 3, 128, 8
CU_SOURCE = Path(wk.__file__).resolve().parents[2] / "csrc" / "whole_body_kernel.cu"


def assert_rel(got, want, tol=1e-6):
    """max |got - want| <= tol * max(1, max |want|): the same arithmetic in
    another float order (batched matmuls, a batched FK), so relative to
    the largest entry (thrust is ~150 N where joint accelerations are ~1)."""
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


def _scenario_obs(obs):
    """B different observations: base offsets, tilts and arm angles; the
    target quaternion stays a unit quaternion."""
    def vary(i, x):
        return x if x.shape[-1] == 4 else x + 0.03 * i * torch.linspace(-1.0, 1.0, x.shape[-1])
    return tree_map(lambda x: torch.stack([vary(i, x) for i in range(B)]), obs)


def _params(mode, k=K, h=H):
    if mode == "position":
        return twb.position_mode_params(n_samples=k, n_horizon=h)
    p = twb.WholeBodyMPPIParams()
    return dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, n_samples=k, n_horizon=h))


@pytest.mark.parametrize("noise", ["z", "spill", "nospill"])
@pytest.mark.parametrize("mode", ["position", "attitude"])
def test_batched_step_equals_unbatched_steps(mode, noise):
    params = _params(mode)
    spill = noise != "nospill"
    step_b, init_b = twb.make_whole_body_solver(params, device="cpu", low_k_guard="off",
                                                n_scenarios=B, noise_spill=spill)
    step_1, init_1 = twb.make_whole_body_solver(params, device="cpu", low_k_guard="off",
                                                noise_spill=spill)
    obs = _scenario_obs(twb.default_obs(device="cpu"))
    gen = torch.Generator().manual_seed(1)
    zs = [torch.randn((B, K, H, wk.A_TOTAL), generator=gen) if noise == "z" else None
          for _ in range(2)]
    st_b, seeds = init_b(9), scenario_seeds(9, B)
    for z in zs:
        # each solve from the same state: the softmin would amplify a
        # last-bit difference of one solve's warm start in the next
        out_b, st_next = step_b(st_b, obs, z)
        for b in range(B):
            st = MPPIState(u_prev=st_b.u_prev[b], sigma=st_b.sigma[b], seed=seeds[b],
                           step=st_b.step)
            out, st = step_1(st, tree_map(lambda x: x[b], obs), None if z is None else z[b])
            for got, want in zip(out_b, out):
                assert_rel(got[b], want)
            assert_rel(st_next.u_prev[b], st.u_prev)
            assert_rel(st_next.sigma[b], st.sigma)
        st_b = st_next
    assert st_b.step == 2 and st_b.seed.tolist() == seeds


@pytest.mark.parametrize("mode", ["position", "attitude"])
def test_batched_step_matches_jax_vmap(mode):
    """The batched kernel step against ``jax.vmap`` of the JAX XLA step,
    each scenario's noise rebuilt from its key; two solves."""
    jp = small(jwb.position_mode_params() if mode == "position"
               else jwb.WholeBodyMPPIParams(), k=K, h=H)
    jstep, jinit = jwb.make_whole_body_solver(jp, low_k_guard="off")
    keys = scenario_keys(jax.random.key(4), B)
    jstates = jax.vmap(jinit)(keys)
    jobs1 = perturbed_obs(jwb.default_obs())
    jobs = jax.tree.map(lambda x: np.stack([np.asarray(x) * (1.0 + 0.05 * i * (x.shape[-1] != 4))
                                            for i in range(B)]), jobs1)
    vstep = jax.jit(jax.vmap(jstep))
    tstep, _ = twb.make_whole_body_solver(to_port(jp), device="cpu", low_k_guard="off",
                                          n_scenarios=B)
    tstate = convert.batched_state_from_numpy(np.asarray(jstates.u_prev),
                                              np.asarray(jstates.sigma), range(B),
                                              device="cpu")
    tobs = tree_map(lambda x: torch.tensor(np.asarray(x, np.float32)), jobs)
    keys_now = list(keys)
    for tol in (2e-3, 2e-3):
        zs = []
        for b in range(B):
            keys_now[b], z = shared_z(keys_now[b], K, H)
            zs.append(z)
        jout, jstates = vstep(jstates, jobs)
        tout, tstate = tstep(tstate, tobs, np.stack(zs))
        np.testing.assert_allclose(N(tout.u_seq), np.asarray(jout.u_seq), rtol=tol, atol=tol)
        np.testing.assert_allclose(N(tout.action), np.asarray(jout.action), rtol=tol, atol=tol)
        np.testing.assert_allclose(N(tstate.u_prev), np.asarray(jstates.u_prev),
                                   rtol=tol, atol=tol)


def _kernel_inputs(params, batched: bool):
    kc = wk.make_kernel_config(params)
    obs = twb.default_obs(device="cpu")
    if batched:
        obs = _scenario_obs(obs)
    sigma = torch.as_tensor(params.mppi.sigma, dtype=torch.float32)
    sc = wk.pack_scalars(obs, sigma * params.mppi.sigma_scale_fn(obs))
    _, init = twb.make_whole_body_solver(params, device="cpu", low_k_guard="off",
                                         n_scenarios=B if batched else None)
    st = init(21)
    return kc, sc, st.u_prev, wk.philox_keys(st.seed, "cpu")


@pytest.mark.parametrize("batched", [False, True])
def test_nospill_pair_equals_spill_pair(batched):
    """Rows 4+5 against rows 1+3: the same Philox draw in both passes, so
    identical costs and partials, and the same du and m2."""
    kc, sc, u_prev, seed = _kernel_inputs(_params("position"), batched)
    s1, m1, e1, eps = wk.wb_cost(kc, sc, u_prev, None, seed, 6)
    s4, m4, e4 = wk.wb_cost_nospill(kc, sc, u_prev, seed, 6)
    for a, b in ((s4, s1), (m4, m1), (e4, e1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    du3, m2_3 = wk.wb_update(kc, eps, s1, m1, e1)
    du5, m2_5 = wk.wb_update_regen(kc, sc, s4, m4, e4, seed, 6)
    assert_rel(du5, du3)
    assert_rel(m2_5, m2_3)


@pytest.mark.parametrize("batched", [False, True])
def test_shard_updates_equal_the_fused_updates_with_the_local_normalizers(batched):
    """Rows 7 and 6 with (rho, eta) given equal rows 3 and 5 when the given
    pair is this solve's own; a sample offset shifts the draw."""
    kc, sc, u_prev, seed = _kernel_inputs(_params("position"), batched)
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, seed, 2, k_off=256)
    se = wk.softmin_normalizers(kc, m, e)
    assert se.shape == s.shape[:-1] + (2,)
    du3, m2_3 = wk.wb_update(kc, eps, s, m, e)
    for got in (wk.wb_update_shard(kc, eps, s, se),
                wk.wb_update_shard_regen(kc, sc, s, se, seed, 2, 256),
                wk.wb_update_regen(kc, sc, s, m, e, seed, 2, 256)):
        assert_rel(got[0], du3)
        assert_rel(got[1], m2_3)
    torch.testing.assert_close(eps, wk.philox_eps(kc, sc, seed, 2, 256))
    assert not torch.allclose(eps, wk.philox_eps(kc, sc, seed, 2, 0))


def test_philox_sample_offset_is_a_slice_of_the_one_rank_draw():
    full = sampling.philox_normals(2**40 + 7, 5, 256, 4, 11)
    for off in (0, 64, 128, 192):
        part = sampling.philox_normals(2**40 + 7, 5, 64, 4, 11, sample_offset=off)
        torch.testing.assert_close(part, full[..., off:off + 64], rtol=0, atol=0)


def test_pack_scalars_and_schedule_batched_equal_per_scenario():
    obs = _scenario_obs(twb.default_obs(device="cpu"))
    for schedule in (twb.ee_error_sigma_schedule(),
                     twb.ee_error_sigma_schedule(r0=0.1, base_floor=0.005)):
        scale = schedule(obs)
        for b in range(B):
            ob = tree_map(lambda x: x[b], obs)
            torch.testing.assert_close(torch.broadcast_to(scale[b], (11,)),
                                       torch.broadcast_to(schedule(ob), (11,)))
    sigma = torch.as_tensor(twb.default_sigma(), dtype=torch.float32)
    sc = wk.pack_scalars(obs, sigma)
    assert sc.shape == (B, wk.SC_LEN)
    for b in range(B):
        torch.testing.assert_close(sc[b], wk.pack_scalars(tree_map(lambda x: x[b], obs), sigma))
    back = wk.obs_from_scalars(sc)
    torch.testing.assert_close(back.state.q, obs.state.q)
    torch.testing.assert_close(back.ee_target.quat, obs.ee_target.quat)


def test_batched_init_and_state_from_the_jax_vmapped_states():
    jp = small(jwb.position_mode_params(), k=K, h=H)
    _, jinit = jwb.make_whole_body_solver(jp)
    js = jax.vmap(jinit)(scenario_keys(jax.random.key(0), B))
    st = convert.batched_state_from_numpy(np.asarray(js.u_prev), np.asarray(js.sigma),
                                          [5, 6, 7], device="cpu", step=4)
    _, init = twb.make_whole_body_solver(to_port(jp), device="cpu", n_scenarios=B)
    mine = init([5, 6, 7])
    torch.testing.assert_close(st.u_prev, mine.u_prev)
    torch.testing.assert_close(st.sigma, mine.sigma)
    assert st.seed.dtype == torch.int64 and st.seed.tolist() == [5, 6, 7] and st.step == 4
    assert init(3).seed.tolist() == scenario_seeds(3, B)
    with pytest.raises(ValueError, match="2 seeds for 3 scenarios"):
        init([1, 2])
    with pytest.raises(ValueError, match=r"expected u_prev \(B, H, A\)"):
        convert.batched_state_from_numpy(np.zeros((B, H, 11)), np.zeros((B, 10)), range(B),
                                         device="cpu")


def test_torch_backend_refuses_a_scenario_batch(monkeypatch):
    """The plain pipeline takes a scenario batch on the CPU (its cases are
    in tests/test_torch_fleet.py) and, since the plain pipeline runs on the
    card too, it is built for the card with one as without; a
    configuration the kernels refuse still raises under the default
    ``backend="cuda"``, batched or not: the caller chooses the backend."""
    _, init = twb.make_whole_body_solver(_params("position"), device="cpu", backend="torch",
                                         n_scenarios=2)
    assert init(0).u_prev.shape == (2, H, wk.A_TOTAL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    refused = dataclasses.replace(_params("position"), mppi=dataclasses.replace(
        _params("position").mppi, zero_mean_noise=True))
    for n in (None, 2):
        twb.make_whole_body_solver(refused, device="cuda", backend="torch", n_scenarios=n)
        with pytest.raises(ValueError, match="zero_mean_noise"):
            twb.make_whole_body_solver(refused, device="cuda", n_scenarios=n)


def test_seed_arguments():
    cpu = torch.device("cpu")
    lead_seeds = torch.tensor([1, 2, 3], dtype=torch.int64)
    assert wk.philox_keys(lead_seeds, cpu) is lead_seeds
    assert wk._key_ptr(lead_seeds, (3,), cpu) == lead_seeds.data_ptr()
    one = wk.philox_keys(-1, cpu)
    assert one.shape == (1,) and one.dtype == torch.int64 and wk.philox_keys(2**64 - 1, cpu) is one
    assert wk._key_list(one) == [2**64 - 1] and wk._key_list(lead_seeds) == [1, 2, 3]
    assert wk._key_ptr(one, (), cpu) == one.data_ptr()
    with pytest.raises(ValueError, match="seeds: expected a contiguous int64"):
        wk._key_ptr(lead_seeds.float(), (3,), cpu)
    with pytest.raises(ValueError, match=r"shape \(1,\)"):
        wk._key_ptr(lead_seeds, (), cpu)


def _c_params(src: str, fn: str) -> int:
    sig = re.search(rf"int {fn}\((.*?)\)\s*\{{", src, re.S).group(1)
    return len([p for p in sig.split(",") if p.strip()])


def test_c_interface_matches_the_cuda_source():
    """Argument counts of the three C entry points against their ctypes
    declarations, and every kernel variant instantiated: 3 modes x 3
    pass-1 variants, 4 pass-2 variants."""
    src = CU_SOURCE.read_text()

    class Fake:
        class F:
            pass

        wb_cost_launch, wb_update_launch, wb_prologue_launch = F(), F(), F()

    fake = Fake()
    orig = wk.build.load_library
    wk._lib.cache_clear()
    try:
        wk.build.load_library = lambda name: fake
        lib = wk._lib()
    finally:
        wk.build.load_library = orig
        wk._lib.cache_clear()
    assert len(lib.wb_cost_launch.argtypes) == _c_params(src, "wb_cost_launch") == 15
    assert len(lib.wb_update_launch.argtypes) == _c_params(src, "wb_update_launch") == 20
    assert len(lib.wb_prologue_launch.argtypes) == _c_params(src, "wb_prologue_launch") == 5
    cases = re.findall(r"WB_COST_CASE\((MODE_\w+), (\d), (true|false), (true|false)\)", src)
    assert sorted((m, int(v)) for m, v, _, _ in cases) == sorted(
        (m, v) for m in ("MODE_ATTITUDE", "MODE_POSITION", "MODE_WRENCH") for v in range(3))
    assert {(v, d, s) for _, v, d, s in cases} == {
        ("0", "false", "false"), ("1", "true", "true"), ("2", "true", "false")}
    updates = set(re.findall(r"WB_UPDATE_VARIANT\((true|false), (true|false)\)", src))
    assert updates == {(a, b) for a in ("true", "false") for b in ("true", "false")}
    assert "wb_update_kernel<RG, GV, R><<<" in src
