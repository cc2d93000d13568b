"""The port's kernel module (``ops/cuda/whole_body_kernel``) on the CPU.

With the module's plain versions, the port's kernel step matches the JAX
Pallas step run as the JAX package's own tests run it
(``use_prng=False, interpret=True``) on shared noise.  Also: the plain
versions' contracts (partials, Philox spill, update), the configuration
checks with the JAX kernel's messages, and the C interface — the ctypes
struct and the scalar-pack layout are checked against the CUDA source,
which this machine cannot compile.
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.ops.pallas.whole_body_kernel import (
    make_whole_body_pallas_step,
)
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops import weights as tweights
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import build
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

from torch_parity import (  # noqa: F401
    N, obs_to_port, shared_z, small, to_port, torch_one_thread, wrench_params,
)

CU_SOURCE = Path(wk.__file__).resolve().parents[2] / "csrc" / "whole_body_kernel.cu"


@pytest.mark.parametrize("mode", ["attitude", "wrench"])
def test_kernel_step_matches_jax_pallas(mode):
    jp = small(jwb.WholeBodyMPPIParams(), k=256, h=12) if mode == "attitude" \
        else wrench_params(k=256, h=12)
    jstep = make_whole_body_pallas_step(jp, use_prng=False, interpret=True)
    _, jinit = jwb.make_whole_body_solver(jp, low_k_guard="off")
    tstep = wk.make_whole_body_cuda_step(to_port(jp), device="cpu")
    _, tinit = twb.make_whole_body_solver(to_port(jp), device="cpu", low_k_guard="off")
    jobs = jwb.default_obs()
    js, ts = jinit(jax.random.key(7)), tinit(7)
    key = js.key
    for _ in range(2):
        key, z = shared_z(key, 256, 12)
        u_j, js = jstep(js, jobs)
        u_t, ts = tstep(ts, obs_to_port(jobs), z)
        np.testing.assert_allclose(N(u_t), np.asarray(u_j), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(N(ts.u_prev), np.asarray(js.u_prev), rtol=2e-3, atol=2e-3)


def _setup(make=lambda: twb.position_mode_params(n_samples=256, n_horizon=12)):
    params = make()
    kc = wk.make_kernel_config(params)
    obs = twb.default_obs(device="cpu")
    sigma = torch.as_tensor(params.mppi.sigma, dtype=torch.float32)
    sc = wk.pack_scalars(obs, sigma)
    u_prev = torch.zeros((kc.n_horizon, wk.A_TOTAL))
    return params, kc, obs, sc, u_prev


def test_wb_cost_plain_partials_and_philox_spill():
    params, kc, obs, sc, u_prev = _setup()
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, seed=99, step=4)
    assert s.shape == (256,) and m.shape == e.shape == (256 // wk.BLOCK,)
    z = sampling.philox_normals(99, 4, 256, 12, 11)
    torch.testing.assert_close(eps, z * sc[wk.SC_SIGMA:wk.SC_SIGMA + 11].view(11, 1, 1))
    blk = s.view(-1, wk.BLOCK)
    torch.testing.assert_close(m, blk.min(dim=1).values)
    torch.testing.assert_close(e, torch.exp((m[:, None] - blk) / params.mppi.lam).sum(1))
    # explicit noise reproduces the same costs
    s2, _, _, eps2 = wk.wb_cost(kc, sc, u_prev, eps.clone())
    torch.testing.assert_close(s2, s)
    torch.testing.assert_close(eps2, eps)


def test_wb_update_plain_is_the_softmin_average():
    params, kc, obs, sc, u_prev = _setup()
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, seed=5, step=0)
    du, m2 = wk.wb_update(kc, eps, s, m, e)
    w = tweights.softmin_weights(s, params.mppi.lam)
    noise = eps.permute(2, 1, 0)  # (K, H, A)
    want = tweights.weighted_noise_average(w, noise)          # (H, A)
    torch.testing.assert_close(du.view(11, 12).T, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m2.view(11, 12).T, torch.einsum("k,kha->ha", w, noise * noise),
                               rtol=1e-5, atol=1e-6)


def test_scalar_pack_round_trip():
    _, kc, obs, sc, _ = _setup()
    assert sc.shape == (wk.SC_LEN,)
    back = wk.obs_from_scalars(sc)
    for a, b in ((back.state.q, obs.state.q), (back.state.base.pos, obs.state.base.pos),
                 (back.ee_target.quat, obs.ee_target.quat), (back.base_target, obs.base_target)):
        torch.testing.assert_close(a, b)
    torch.testing.assert_close(sc[wk.SC_GB:wk.SC_GB + 3], torch.tensor([0.0, 0.0, -9.81]))


BAD_CONFIGS = {
    "multiple": lambda p: dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, n_samples=200)),
    "unknown control mode": lambda p: dataclasses.replace(
        p, model=dataclasses.replace(p.model, control_mode="spline")),
    "orientation metric": lambda p: dataclasses.replace(
        p, cost=dataclasses.replace(p.cost, ori_mode="euler_zyx")),
    "zero_mean_noise": lambda p: dataclasses.replace(
        p, mppi=dataclasses.replace(p.mppi, zero_mean_noise=True)),
    "diagonal sigma": lambda p: dataclasses.replace(
        p, mppi=dataclasses.replace(p.mppi, sigma=np.eye(11))),
    "exclusive": lambda p: dataclasses.replace(
        p, mppi=dataclasses.replace(p.mppi, adaptive_sigma=True)),
    "parallel-in-time": lambda p: dataclasses.replace(
        p, model=dataclasses.replace(p.model, time_parallel=False)),
    "link_7": lambda p: dataclasses.replace(
        p, model=dataclasses.replace(p.model, arm_tip="end_effector")),
}


@pytest.mark.parametrize("match", sorted(BAD_CONFIGS))
def test_rejects_unsupported_configs(match):
    with pytest.raises(ValueError, match=match):
        wk.make_kernel_config(BAD_CONFIGS[match](twb.WholeBodyMPPIParams()))


def test_rejects_what_the_jax_kernel_rejects():
    params = jwb.WholeBodyMPPIParams()
    for match in sorted(BAD_CONFIGS):
        bad_j = BAD_CONFIGS[match](params)
        with pytest.raises(ValueError, match=match):
            make_whole_body_pallas_step(bad_j)
        with pytest.raises(ValueError, match=match):
            wk.make_kernel_config(to_port(bad_j))


def _c_struct_fields(src: str):
    body = re.search(r"struct WbParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        for name in names.split(","):
            dims = [int(defines.get(d, d)) for d in re.findall(r"\[(\w+)\]", name)]
            fields.append((name.split("[")[0].strip(), ctype, int(np.prod(dims or [1]))))
    return fields


def test_ctypes_struct_matches_the_cuda_source():
    src = CU_SOURCE.read_text()
    want = _c_struct_fields(src)
    got = []
    for name, ctype in wk.WbParams._fields_:
        n = 1
        while hasattr(ctype, "_length_"):  # nested ctypes arrays
            n, ctype = n * ctype._length_, ctype._type_
        got.append((name, "int" if ctype is ctypes.c_int else "float", n))
    assert got == want
    assert ctypes.sizeof(wk.WbParams) == 4 * sum(n for _, _, n in want)


def test_scalar_layout_and_constants_match_the_cuda_source():
    defines = dict(re.findall(r"#define (\w+) (\d+)", CU_SOURCE.read_text()))
    for name in ("SC_Q0", "SC_QD0", "SC_POS0", "SC_VEL0", "SC_TPOS", "SC_TQUAT", "SC_BTGT",
                 "SC_SIGMA", "SC_RPY0", "SC_OM0", "SC_BQ0", "SC_GB", "SC_LEN"):
        assert int(defines[name]) == getattr(wk, name), name
    assert int(defines["WB_BLOCK"]) == wk.BLOCK
    assert int(defines["WB_MAX_OBS"]) == wk.MAX_OBSTACLES
    assert int(defines["WB_A"]) == wk.A_TOTAL


def test_kernel_config_struct_values():
    params = twb.wrench_mode_params()
    kc = wk.make_kernel_config(params)
    s = kc.struct
    assert (s.mode, s.h, s.k, s.rotor_lag, s.couple) == (2, 50, 4096, 1, 0)
    assert kc.n_blocks == 4096 // wk.BLOCK
    np.testing.assert_allclose(s.rate_alpha, 1.0 - 0.01 * 12.0, rtol=1e-6)
    np.testing.assert_allclose(s.lag_alpha, np.exp(-0.01 / 0.02), rtol=1e-6)
    np.testing.assert_allclose(list(s.q_lo), params.model.chain().lower, rtol=1e-6)


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    d1 = build._build_dir("whole_body_kernel")
    assert d1.parent == build.BUILD_ROOT and d1.name.startswith("whole_body_kernel-")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_wrappers_refuse_other_devices():
    _, kc, obs, sc, u_prev = _setup()
    with pytest.raises(ValueError, match="expected a contiguous float32"):
        wk._check(sc.double(), (wk.SC_LEN,), sc.device, "sc")
    with pytest.raises(ValueError, match="expected a contiguous float32"):
        wk._check(u_prev.T, (11, 12), u_prev.device, "u_prev")
