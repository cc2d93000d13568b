"""On-card smoke run of the PyTorch/CUDA port's whole-body solve.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels from ``csrc/`` at
first use.  Phases (one line each, any failure exits non-zero before the
final ``ok`` line):

1. device and build: the card's name and power limit, ``ptxas -v`` lines;
2. each kernel against its plain PyTorch version at K=4096, H=50 in the
   attitude, position and wrench presets, with explicit noise, plus one full
   step against the plain pipeline;
3. the Philox path: the kernel's spilled noise against the plain Philox;
4. the serving path: 50 packed solves of the flagship configuration through
   ``make_packed_step``, counting kernel launches, then timings;
5. one ``kernels`` JSON line, the ``nvidia-smi`` line, and the ``ok`` line.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import build
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.solver import mppi, serving
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb

K, H, A = 4096, 50, wk.A_TOTAL
N_SERVE = 50
TOL_COST = 1e-4      # max|dS| / max(1, max|S|): recurrence vs operator form
TOL_UPDATE = 1e-5    # max|d du| / max|du|: summation order only
TOL_STEP = 2e-3      # |a - b| <= TOL (1 + |b|): the JAX parity tolerance
TOL_NOISE = 1e-5     # erfinvf vs torch.erfinv on the card

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores

# Arithmetic per sample and horizon step of wb_cost in attitude mode, all
# instructions counted at the float32 rate (a lower bound on time):
# 11 Philox draws (10 rounds x ~10 integer ops) + 11 erfinv and scalings
# (~35), arm double integration and clamp (70), rotor lag + 3 PD axes +
# rpy quaternion + thrust/velocity/position (140), 7-joint FK (~580), cost
# stack (~150).
WB_COST_OPS_PER_SAMPLE_STEP = 11 * 100 + 11 * 35 + 70 + 140 + 580 + 150
# wb_update per noise element: weight (exp, subtract, scale, divide ~16)
# and the two weighted accumulations (4).
WB_UPDATE_OPS_PER_ELEMENT = 20
KERNEL_SOURCE = "quadrotor_manipulator_mppi_tpu_torch/csrc/whole_body_kernel.cu"
TPU_KERNEL = "quadrotor_manipulator_mppi_tpu/ops/pallas/whole_body_kernel.py"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync() -> None:
    torch.cuda.synchronize()


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def presets():
    return {"attitude": wb.WholeBodyMPPIParams(),
            "position": wb.position_mode_params(),
            "wrench": wb.wrench_mode_params()}


def phase_build(dev) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.load_library("whole_body_kernel")
    print(f"[1] device {torch.cuda.get_device_name(dev)} | {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.build_report("whole_body_kernel").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")
    return smi


def inputs(params, dev, gen):
    """Scalar pack, warm start and explicit noise of one solve."""
    cfg = params.mppi
    step, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off")
    state = init(0)
    obs = wb.default_obs(device=dev)
    sigma = state.sigma * cfg.sigma_scale_fn(obs)
    z = torch.randn((K, H, A), generator=gen, device=dev)
    eps = (z * sigma).permute(2, 1, 0).contiguous()
    return state, obs, z, wk.pack_scalars(obs, sigma), eps


def phase_kernels(dev, errs) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    for mode, params in presets().items():
        kc = wk.make_kernel_config(params)
        state, obs, z, sc, eps = inputs(params, dev, gen)
        u_prev = state.u_prev.contiguous()
        s_k, m_k, e_k, _ = wk.wb_cost(kc, sc, u_prev, eps)
        s_p, _, _, _ = wk.wb_cost_plain(kc, sc, u_prev, eps)
        sync()
        abs_s = (s_k - s_p).abs().max().item()
        rel_s = abs_s / max(1.0, s_p.abs().max().item())
        du_k, m2_k = wk.wb_update(kc, eps, s_k, m_k, e_k)
        du_p, m2_p = wk.wb_update_plain(kc, eps, s_k, m_k, e_k)
        sync()
        abs_du = max((du_k - du_p).abs().max().item(), (m2_k - m2_p).abs().max().item())
        rel_du = max((du_k - du_p).abs().max().item() / du_p.abs().max().item(),
                     (m2_k - m2_p).abs().max().item() / m2_p.abs().max().item())

        step_k = wk.make_whole_body_cuda_step(params, dev)
        step_p = mppi.make_step(params.mppi, *wb.rollout_cost_fns(params))
        u_k, st_k = step_k(state, obs, z)
        u_p, st_p = step_p(state, obs, z)
        sync()
        step_err = max(((a - b).abs() / (1.0 + b.abs())).max().item() for a, b in
                       ((u_k, u_p), (st_k.u_prev, st_p.u_prev), (st_k.sigma, st_p.sigma)))
        print(f"[2] {mode:8s} wb_cost max|dS| {abs_s:.3e} (rel {rel_s:.2e}, S in "
              f"[{s_p.min().item():.1f}, {s_p.max().item():.1f}]) | wb_update rel {rel_du:.2e} "
              f"| full step {step_err:.2e}", flush=True)
        if not (rel_s <= TOL_COST and rel_du <= TOL_UPDATE and step_err <= TOL_STEP):
            fail(f"{mode}: kernel disagrees with its plain version")
        errs["wb_cost"] = max(errs["wb_cost"], abs_s)
        errs["wb_update"] = max(errs["wb_update"], abs_du)


def phase_philox(dev) -> None:
    params = wb.WholeBodyMPPIParams()
    kc = wk.make_kernel_config(params)
    state, obs, _, sc, _ = inputs(params, dev, torch.Generator(device=dev))
    seed, step = 0x5EED_0123_4567_89AB, 17
    _, _, _, eps = wk.wb_cost(kc, sc, state.u_prev.contiguous(), None, seed, step)
    sigma = sc[wk.SC_SIGMA:wk.SC_SIGMA + A].view(A, 1, 1)
    z_k = eps / sigma
    z_p = sampling.philox_normals(seed, step, K, H, A, dev)
    sync()
    err = (z_k - z_p).abs().max().item()
    print(f"[3] philox spill vs plain max|dz| {err:.2e} | z mean {z_k.mean().item():+.5f} "
          f"std {z_k.std().item():.5f} max|z| {z_k.abs().max().item():.3f}", flush=True)
    if not err <= TOL_NOISE:
        fail("Philox spill disagrees with the plain Philox stream")


def phase_serving(dev):
    params = wb.WholeBodyMPPIParams()
    pstep, pinit = serving.make_packed_step(params, device=dev)
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    carry = pinit(0)
    for _ in range(3):  # warm up (allocator, library load)
        out, carry = pstep(carry, obs_vec, target_vec)
    sync()
    torch.cuda.reset_peak_memory_stats(dev)

    wk.wb_cost.launches = 0
    wk.wb_update.launches = 0
    outs, block_ms = [], []
    for _ in range(N_SERVE // 10):
        t0 = time.perf_counter()
        for _ in range(10):
            out, carry = pstep(carry, obs_vec, target_vec)
            outs.append(out)
        sync()
        block_ms.append((time.perf_counter() - t0) * 1e3 / 10)
    launches = {"wb_cost": wk.wb_cost.launches, "wb_update": wk.wb_update.launches}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    finite = all(bool(torch.isfinite(o).all()) for o in outs) and bool(
        torch.isfinite(carry.u_prev).all())
    print(f"[4] serving {N_SERVE} solves: launches {launches} | finite {finite} | "
          f"{statistics.median(block_ms):.3f} ms/solve (median of {len(block_ms)} "
          f"blocks of 10) | peak {peak_mib:.1f} MiB", flush=True)
    if launches != {"wb_cost": N_SERVE, "wb_update": N_SERVE} or not finite:
        fail("serving path did not run through both kernels with finite output")

    return launches, statistics.median(block_ms), (pstep, carry, obs_vec, target_vec)


def phase_profile(serve, solve_ms: float) -> None:
    """Where a serving solve's device time goes: CUDA-side profiler events
    of 10 solves, their busy share of the profiled wall time and of the
    unprofiled solve time, and the device ops that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pstep, carry, obs_vec, target_vec = serve
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            out, carry = pstep(carry, obs_vec, target_vec)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in ops)
    launches = sum(e.count for e in ops)
    if not dev_us:
        print("[4] profiler: device time not measured (no CUDA events)", flush=True)
        return
    print(f"[4] profiler: device busy {dev_us / 10:.1f} us/solve; busy share "
          f"{dev_us / wall_us:.3f} of the profiled wall ({wall_us / 10:.1f} us/solve), "
          f"{dev_us / 10 / (solve_ms * 1e3):.3f} of the unprofiled solve; "
          f"{launches / 10:.0f} device ops/solve", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 10:8.1f} us/solve {e.count / 10:6.1f} ops/solve  "
              f"{e.key[:90]}")


def phase_timing(dev):
    params = wb.WholeBodyMPPIParams()
    kc = wk.make_kernel_config(params)
    state, obs, z, sc, _ = inputs(params, dev, torch.Generator(device=dev))
    u_prev = state.u_prev.contiguous()
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, 1, 0)
    rho = m.min()
    w = torch.exp((rho - s) * kc.inv_lam) / torch.sum(e * torch.exp((rho - m) * kc.inv_lam))
    flat = eps.view(A * H, K)

    t = {
        "wb_cost": event_ms(lambda: wk.wb_cost(kc, sc, u_prev, None, 1, 0)),
        "wb_cost_plain": event_ms(lambda: wk.wb_cost_plain(kc, sc, u_prev, None, 1, 0), reps=5),
        "wb_update": event_ms(lambda: wk.wb_update(kc, eps, s, m, e)),
        "wb_update_plain": event_ms(lambda: wk.wb_update_plain(kc, eps, s, m, e)),
        "library_mv": event_ms(lambda: torch.mv(flat, w)),
    }
    step_p = mppi.make_step(params.mppi, *wb.rollout_cost_fns(params))
    step_k = wk.make_whole_body_cuda_step(params, dev)
    t["plain_step"] = host_ms(lambda: step_p(state, obs))
    t["kernel_step"] = host_ms(lambda: step_k(state, obs))
    print("[4] timings (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)

    noise_bytes = A * H * K * 4
    cost_bytes = (wk.SC_LEN + H * A + K + 2 * kc.n_blocks) * 4 + noise_bytes
    cost_ops = K * H * WB_COST_OPS_PER_SAMPLE_STEP
    update_bytes = noise_bytes + (K + 2 * kc.n_blocks + 2 * A * H) * 4
    update_ops = A * H * K * WB_UPDATE_OPS_PER_ELEMENT
    bounds = {}
    for name, nbytes, ops in (("wb_cost", cost_bytes, cost_ops),
                              ("wb_update", update_bytes, update_ops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return t, bounds


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    smi = phase_build(dev)
    errs = {"wb_cost": 0.0, "wb_update": 0.0}
    phase_kernels(dev, errs)
    phase_philox(dev)
    launches, solve_ms, serve = phase_serving(dev)
    t, bounds = phase_timing(dev)
    phase_profile(serve, solve_ms)
    kernels = [
        {"name": "wb_cost", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL}:575 _cost_kernel_store, {TPU_KERNEL}:564 _cost_kernel_noise",
         "launches": launches["wb_cost"], "max_abs_err": errs["wb_cost"],
         "ms": t["wb_cost"], "plain_ms": t["wb_cost_plain"],
         "bound_ms": bounds["wb_cost"][0], "bound_by": bounds["wb_cost"][1],
         "library_ms": None},
        {"name": "wb_update", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL}:655 _update_kernel_fused_noise (_fused_update_body :624)",
         "launches": launches["wb_update"], "max_abs_err": errs["wb_update"],
         "ms": t["wb_update"], "plain_ms": t["wb_update_plain"],
         "bound_ms": bounds["wb_update"][0], "bound_by": bounds["wb_update"][1],
         "library_ms": t["library_mv"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"serving solve {solve_ms:.4f} ms on {smi}")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
