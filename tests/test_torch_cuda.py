"""On-card cases of the port: each CUDA kernel against its plain PyTorch
version at a small size.  Marked ``cuda``; each case decides in its body
whether a card exists and skips otherwise.  This file imports neither JAX
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.solver import mppi, serving
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
    _, _, _, eps = wk.wb_cost(kc, sc, state.u_prev, None, seed=2**40 + 3, step=9)
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
    carry = pinit(0)
    n_cost, n_update = wk.wb_cost.launches, wk.wb_update.launches
    for _ in range(3):
        out, carry = pstep(carry, obs_vec, target_vec)
    assert (wk.wb_cost.launches - n_cost, wk.wb_update.launches - n_update) == (3, 3)
    assert out.shape == (serving.OUT_SIZE,) and bool(torch.isfinite(out).all())
