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
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, wk.philox_keys(99, "cpu"), step=4)
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
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, wk.philox_keys(5, "cpu"), step=0)
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
    assert "WB_MAX_OBS" not in defines  # the spheres come from a device buffer of any length
    assert int(defines["WB_A"]) == wk.A_TOTAL


SCAN_HEADER = CU_SOURCE.parent / "warp_scan.cuh"


def _defines(*paths):
    return {k: int(v) for path in paths
            for k, v in re.findall(r"#define (\w+) (\d+)", path.read_text())}


@pytest.mark.parametrize("define,attr", [
    ("WB_BLOCK", "BLOCK"), ("WARP_LANES", "WARP_LANES"),
    ("WARP_SCAN", "SCAN_STEPS"), ("WB_SCAN", "SCAN_STEPS"),
])
def test_cost_constants_match_the_cuda_source(define, attr):
    """wb_cost's block and scan constants, in the kernel source or the scan
    header it includes, against the wrapper's."""
    assert _defines(CU_SOURCE, SCAN_HEADER)[define] == getattr(wk, attr)


def test_cost_layouts_match_the_cuda_source():
    """One block of BLOCK warps (a softmin partial group, one sample per
    warp) whose scans cover a chunk of WARP_LANES steps."""
    src = CU_SOURCE.read_text()
    assert src.count('#include "warp_scan.cuh"') == 1
    assert 2 ** wk.SCAN_STEPS == wk.WARP_LANES
    assert wk.BLOCK * wk.WARP_LANES <= 1024
    assert "wb_cost_kernel<MODE, DRAW, STORE><<<grid, WB_BLOCK * WARP_LANES," in src
    assert "const dim3 grid(p.k / WB_BLOCK, n_scen);" in src


@pytest.mark.parametrize("arg,bad,match", [
    ("sc", lambda sc, u, e: sc[:-1], "sc: expected"),
    ("u_prev", lambda sc, u, e: u[:-1], "u_prev: expected"),
    ("eps", lambda sc, u, e: e[:, :, :-16], "eps: expected"),
    ("eps", lambda sc, u, e: e.transpose(1, 2).contiguous().transpose(1, 2), "eps: expected"),
    ("seeds", lambda sc, u, e: torch.zeros(1, dtype=torch.int32), "seeds: expected"),
])
def test_cost_launch_refuses_malformed_inputs(arg, bad, match):
    """The launcher checks shape, dtype and contiguity before any launch."""
    _, kc, _, sc, u_prev = _setup()
    eps = torch.zeros((wk.A_TOTAL, kc.n_horizon, kc.n_samples))
    args = {"sc": sc, "u_prev": u_prev, "eps": eps, "seeds": wk.philox_keys(1, "cpu")}
    args[arg] = bad(sc, u_prev, eps)
    variant = 0 if arg == "eps" else 1
    with pytest.raises(ValueError, match=match):
        wk._launch_cost(kc, "wb_cost", args["sc"], args["u_prev"],
                        args["eps"] if variant == 0 else None,
                        args["seeds"] if variant else None, 0, 0, variant)


@pytest.mark.parametrize("make,match", [
    (lambda: twb.position_mode_params(n_samples=4104, n_horizon=12), "multiple of 16"),
    (lambda: twb.position_mode_params(n_samples=256, n_horizon=wk.max_horizon() + 1),
     "horizon too long"),
])
def test_kernel_config_refuses_what_the_layouts_cannot_run(make, match):
    with pytest.raises(ValueError, match=match):
        wk.make_kernel_config(make())


@pytest.mark.parametrize("h", [600, 1112, "max"])
def test_kernel_config_takes_horizons_up_to_the_opted_in_shared_memory(h):
    """Long horizons run: the launcher opts into shared memory above 48 KB,
    and the check counts the noise stage (spill and explicit noise only)
    and the static share."""
    h = wk.max_horizon() if h == "max" else h
    kc = wk.make_kernel_config(twb.position_mode_params(n_samples=256, n_horizon=h))
    assert kc.n_horizon == h
    need = [wk.cost_smem_bytes(h, v) for v in range(3)]
    assert max(need) <= wk.SMEM_OPTIN and need[2] < need[1] == need[0]
    assert max(wk.cost_smem_bytes(wk.max_horizon() + 1, v) for v in range(3)) > wk.SMEM_OPTIN


@pytest.mark.parametrize("pattern", [
    r"__shared__ float s_grp\[WB_BLOCK\];",  # the static share
    r"STORE \|\| !DRAW \? \(size_t\)WB_A \* WARP_LANES \* \(WB_BLOCK \+ 1\) \* sizeof\(float\)",
    r"const size_t warm = \(size_t\)\(SC_LEN \+ p\.h \* WB_A\) \* sizeof\(float\);",
    r"allow_smem\(wb_cost_kernel<MODE, DRAW, STORE>, warm \+ stage\);",
])
def test_shared_memory_accounting_matches_the_cuda_source(pattern):
    """What :func:`cost_smem_bytes` counts is what the source declares and
    launches with (the stage only where the kernel spills or reads noise),
    and the launcher opts in to it."""
    assert re.search(pattern, CU_SOURCE.read_text())


@pytest.mark.parametrize("make", [twb.WholeBodyMPPIParams, twb.position_mode_params,
                                  twb.wrench_mode_params])
def test_scan_powers_are_the_step_maps_powers(make):
    """wb_cost's scans take each constant step map raised to 2^i:
    the 2x2 axis responses and the rotor-lag, drag and rate factors of the
    struct (float32), squared in float64."""
    s = wk.make_kernel_config(make()).struct
    for i in range(3):
        a = np.reshape(np.array(s.ax_a[i], np.float64), (2, 2))
        for j in range(wk.SCAN_STEPS):
            np.testing.assert_allclose(np.reshape(s.ax_pow[i][j], (2, 2)),
                                       np.linalg.matrix_power(a, 2 ** j), rtol=1e-6, atol=1e-7)
    for name, c in (("lag_pow", s.lag_alpha), ("drag_pow", s.drag_alpha),
                    ("rate_pow", s.rate_alpha)):
        np.testing.assert_allclose(list(getattr(s, name)),
                                   [c ** (2 ** j) for j in range(wk.SCAN_STEPS)], rtol=1e-6)


def test_update_constants_match_the_cuda_source():
    src = CU_SOURCE.read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert int(defines["WB_UPDATE_THREADS"]) == wk.UPDATE_THREADS
    # the rows-per-block instantiations the launcher dispatches to
    cases = re.findall(r"WB_UPDATE_CASE\(RG, GV, (\d+)\)", src)
    assert tuple(int(r) for r in cases) == wk.UPDATE_ROWS


@pytest.mark.parametrize("h,r,blocks", [
    (50, 1, 550), (50, 2, 275), (50, 4, 138), (50, 8, 69),
    (16, 1, 176), (16, 2, 88), (16, 4, 44), (16, 8, 22),
])
def test_update_blocks_per_scenario(h, r, blocks):
    rows = wk.A_TOTAL * h
    assert wk.update_blocks(rows, r) == blocks
    # every row has one block; the last block holds 1..R rows
    assert 0 < rows - (blocks - 1) * r <= r


@pytest.mark.parametrize("regen,n_scen,h,want", [
    (False, 1, 50, 8),      # row 3, the serving solve; row 7 at K_local
    (False, 256, 50, 8),    # row 3, the scenario batch
    (True, 256, 50, 4),     # row 5, the scenario batch
    (True, 1, 50, 2),       # row 6 at K_local: >= 264 blocks
    (False, 1, 16, 8),
    (True, 3, 16, 2),       # 3 x 88 = 264 blocks
    (True, 1, 16, 1),       # fewer rows than the blocks wanted: one per block
])
def test_update_rows_per_block_rule(regen, n_scen, h, want):
    rows = wk.A_TOTAL * h
    r = wk.update_rows_per_block(regen, n_scen, rows)
    assert r == want and r in wk.UPDATE_ROWS and r <= wk.UPDATE_MAX_ROWS[regen]
    more = [x for x in wk.UPDATE_ROWS if r < x <= wk.UPDATE_MAX_ROWS[regen]]
    need = wk.UPDATE_MIN_BLOCKS[regen]
    assert n_scen * wk.update_blocks(rows, r) >= need or r == 1
    assert all(n_scen * wk.update_blocks(rows, x) < need for x in more)


def test_update_launch_refuses_bad_rows_and_misaligned_noise():
    params, kc, obs, sc, u_prev = _setup()
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, wk.philox_keys(5, "cpu"), step=0)
    with pytest.raises(ValueError, match="rows_per_block"):
        wk._launch_update(kc, "wb_update", s, eps=eps, m_part=m, e_part=e, rows_per_block=3)
    shifted = torch.empty(eps.numel() + 1)[1:].view(eps.shape)
    with pytest.raises(ValueError, match="16-byte"):
        wk._launch_update(kc, "wb_update", s, eps=shifted, m_part=m, e_part=e)


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
