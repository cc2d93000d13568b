"""On-card smoke run of the PyTorch/CUDA port: the whole-body solve and the
whole-body closed loop.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels from ``csrc/`` at
first use, one ``nvcc`` per source, all at once.  Phases (each prints its
lines; any failure exits non-zero before the final ``ok`` line):

1. device and build: the card's name and power limit, ``ptxas -v`` lines;
2. each solve kernel against its plain PyTorch version at K=4096, H=50 in
   the attitude, position and wrench presets, with explicit noise, plus one
   full step against the plain pipeline;
3. the Philox path: the kernel's spilled noise against the plain Philox;
4. the serving path: 50 packed solves of the flagship configuration through
   ``make_packed_step``, counting kernel launches, then timings;
5. the plant tick against its plain version at B=1 and B=1024, its
   timings and its registers;
6. the serving episode: 200 control steps of the position-mode closed loop
   at K=4096, H=50 with the plant-tick kernel, counting launches, with a
   profiler breakdown;
7. the reach gate: 1000-step episodes (10 s of flight) for seeds 0-2,
   scored with ``episode_quality``; each must converge and hold;
then one ``kernels`` JSON line, the ``nvidia-smi`` line and the ``ok`` line.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from quadrotor_manipulator_mppi_tpu_torch.evaluation.metrics import episode_quality
from quadrotor_manipulator_mppi_tpu_torch.models import rigid_body as rb
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import build
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
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
# wb_cost on explicit noise draws nothing: the same work less the 11
# Philox draws, and it reads the 9.0 MB of noise where the Philox variant
# writes it.
WB_COST_NOISE_OPS_PER_SAMPLE_STEP = WB_COST_OPS_PER_SAMPLE_STEP - 11 * 100
KERNEL_SOURCE = "quadrotor_manipulator_mppi_tpu_torch/csrc/whole_body_kernel.cu"
TPU_KERNEL = "quadrotor_manipulator_mppi_tpu/ops/pallas/whole_body_kernel.py"
PLANT_SOURCE = "quadrotor_manipulator_mppi_tpu_torch/csrc/plant_kernel.cu"
PLANT_TPU_KERNEL = "quadrotor_manipulator_mppi_tpu/ops/pallas/plant_kernel.py"

# plant_tick arithmetic per vehicle row and 1 ms substep, counted from the
# kernel body (each +, -, *, /, compare, select, sqrt and libm call counted
# as one float32 operation): gravity direction a0 16; frozen nle (7 rows of
# g_tau.a0 and the 7x7x7 Coriolis contraction) 777; M^-1 rhs, integration
# and joint stops 161; arm moment on the base 18; rotation entries 39; ZYX
# angles 6; errors, integrals, altitude law and thrust 40; two lateral laws
# 44; desired tilt 20; attitude backstepping 73; allocation and rotor lag
# 8 x 17; rotor wrench 8 x 11; drag and torques 27; rigid-body integration
# 58; ground test 1; quaternion update 59.
PLANT_OPS_PER_SUBSTEP = 16 + 777 + 161 + 18 + 39 + 6 + 40 + 44 + 20 + 73 + 136 + 88 + 27 \
    + 58 + 1 + 59
PLANT_FLOATS_PER_ROW = pk.STATE_SIZE + pk.DYN_SIZE + 4 + 7 + pk.STATE_SIZE  # in + out
TOL_PLANT = 1e-4     # max |d state| per field: atan2f vs torch.atan2 on one card
N_EPISODE = 200      # phase 6 control steps
N_REACH = 1000       # phase 7 control steps per seed (10 s of flight)
REACH_SEEDS = (0, 1, 2)
SERVING_LOOP = dict(arm_coeffs_per_control=True, plant_kernel=True)


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
    names = ("whole_body_kernel", "plant_kernel")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.build, names))
    for name in names:
        build.load_library(name)
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

    eps_in = eps.clone()
    t = {
        "wb_cost": event_ms(lambda: wk.wb_cost(kc, sc, u_prev, None, 1, 0)),
        "wb_cost_plain": event_ms(lambda: wk.wb_cost_plain(kc, sc, u_prev, None, 1, 0), reps=5),
        "wb_cost_noise": event_ms(lambda: wk.wb_cost(kc, sc, u_prev, eps_in)),
        "wb_cost_noise_plain": event_ms(lambda: wk.wb_cost_plain(kc, sc, u_prev, eps_in),
                                        reps=5),
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
    noise_ops = K * H * WB_COST_NOISE_OPS_PER_SAMPLE_STEP
    for name, nbytes, ops in (("wb_cost", cost_bytes, cost_ops),
                              ("wb_cost_noise", cost_bytes, noise_ops),
                              ("wb_update", update_bytes, update_ops)):
        bounds[name] = bound(nbytes, ops)
    return t, bounds


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") for moving ``nbytes`` and doing
    ``ops`` float32 operations on the H100 SXM."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def plant_config(params):
    m = params.model
    return pk.make_plant_config(m.vehicle, fc.FlightGains(), m.chain(),
                                extra_mass=m.arm_mass_lump)


def perturbed_row(params, dev):
    """One plant row away from equilibrium (tilt, rates, joint motion,
    controller integrals), with its frozen coefficients, a command and an
    arm torque."""
    m = params.model
    plant = wbl.init_plant(m.vehicle, device=dev)
    quat = torch.tensor([0.998, 0.03, -0.04, 0.02], device=dev)
    base = plant.base._replace(
        pos=torch.tensor([0.12, -0.2, 2.05], device=dev), quat=quat / quat.norm(),
        vel=torch.tensor([0.15, -0.1, 0.05], device=dev),
        omega=torch.tensor([0.05, -0.08, 0.02], device=dev))
    ctrl = plant.ctrl._replace(int_err=torch.tensor([0.01, -0.02, 0.005], device=dev),
                               prev_err=torch.tensor([0.02, 0.01, -0.01], device=dev))
    plant = plant._replace(base=base, qdot=torch.full((7,), 0.15, device=dev), ctrl=ctrl)
    dyn = pk.pack_dyn(rb.frozen_arm_coeffs(m.chain(), m.inertials(), plant.q))
    cmd = torch.tensor([0.1, -0.15, 2.1, 0.05], device=dev)
    tau = torch.tensor([1.0, -2.0, 0.5, 3.0, -0.2, 0.1, 0.05], device=dev)
    return pk.pack_plant(plant)[None].contiguous(), dyn[None], cmd[None], tau[None]


PLANT_FIELDS = (("pos", 0, 3), ("quat", 3, 7), ("vel", 7, 10), ("omega", 10, 13),
                ("rotor", 13, 21), ("q", 21, 28), ("qdot", 28, 35), ("int_err", 35, 38),
                ("prev_err", 38, 41), ("m_hat", 41, 44), ("n_hat", 44, 46))


def phase_plant(dev, errs):
    """The plant tick against its plain version at B=1 and B=1024, then
    its timings at both sizes."""
    params = wb.position_mode_params()
    pc = plant_config(params)
    m = params.model
    cases = {1: perturbed_row(params, dev),
             1024: pk.sample_rows(m.vehicle, m.chain(), m.inertials(), 1024, seed=0, device=dev)}
    for rows, args in cases.items():
        got = pk.plant_tick(pc, *args)
        want = pk.plant_tick_plain(pc, *args)
        sync()
        diff = (got - want).abs().max(dim=0).values
        per_field = {name: diff[a:b].max().item() for name, a, b in PLANT_FIELDS}
        worst = max(per_field.values())
        print(f"[5] plant_tick B={rows} max|d| per field: "
              + ", ".join(f"{k} {v:.2e}" for k, v in per_field.items()), flush=True)
        if not (worst <= TOL_PLANT and bool(torch.isfinite(got).all())):
            fail(f"plant_tick disagrees with its plain version at B={rows}")
        errs["plant_tick"] = max(errs["plant_tick"], worst)
    t = {"plant_tick": event_ms(lambda: pk.plant_tick(pc, *cases[1]), reps=200),
         "plant_tick_plain": event_ms(lambda: pk.plant_tick_plain(pc, *cases[1]), reps=5),
         "plant_tick_b1024": event_ms(lambda: pk.plant_tick(pc, *cases[1024]), reps=200),
         "plant_tick_plain_b1024": event_ms(lambda: pk.plant_tick_plain(pc, *cases[1024]),
                                            reps=5)}
    ops = pc.substeps * PLANT_OPS_PER_SUBSTEP
    b1 = bound(PLANT_FLOATS_PER_ROW * 4, ops)
    b1024 = bound(1024 * PLANT_FLOATS_PER_ROW * 4, 1024 * ops)
    print(f"[5] plant_tick timings (ms): B=1 {t['plant_tick']:.4f} (plain "
          f"{t['plant_tick_plain']:.3f}, bound {b1[0]:.2e} by {b1[1]}) | B=1024 "
          f"{t['plant_tick_b1024']:.4f} = {t['plant_tick_b1024'] / 1024 * 1e3:.3f} us/row "
          f"(plain {t['plant_tick_plain_b1024']:.3f}, bound {b1024[0]:.2e} by {b1024[1]}) | "
          f"{ops} ops/row", flush=True)
    for line in build.build_report("plant_kernel").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")
    return t, b1


def serving_episode(params, dev, n_steps):
    """(run, start): ``run(*start(seed))`` is one serving-configuration
    episode of ``n_steps`` control steps from the hover start."""
    run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**SERVING_LOOP),
                                      n_control_steps=n_steps, device=dev)
    _, init = wb.make_whole_body_solver(params, device=dev)
    obs = wb.default_obs(device=dev)

    def start(seed):
        return (wbl.init_plant(params.model.vehicle, device=dev), init(seed), obs.ee_target,
                obs.base_target)

    return run, start


def phase_episode(dev):
    """200 control steps of the serving episode: host ms per step, launch
    counts, finite logs; then a profiled 20-step window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = wb.position_mode_params()
    warm, warm_start = serving_episode(params, dev, 5)
    warm(*warm_start(0))  # warm up (allocator, library loads)
    run, start = serving_episode(params, dev, N_EPISODE)
    args = start(0)
    sync()
    for f in (wk.wb_cost, wk.wb_update, pk.plant_tick):
        f.launches = 0
    t0 = time.perf_counter()
    _, logs = run(*args)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / N_EPISODE
    launches = {"wb_cost": wk.wb_cost.launches, "wb_update": wk.wb_update.launches,
                "plant_tick": pk.plant_tick.launches}
    finite = all(bool(torch.isfinite(f).all()) for f in logs)
    print(f"[6] serving episode {N_EPISODE} control steps (K={K}, H={H}, position mode, "
          f"plant kernel): {step_ms:.3f} ms/control step | launches {launches} | "
          f"finite logs {finite} | final l1_cmd {logs.l1_cmd[-1].item() * 1e3:.2f} mm",
          flush=True)
    if launches != {"wb_cost": N_EPISODE, "wb_update": N_EPISODE, "plant_tick": N_EPISODE} \
            or not finite:
        fail("serving episode did not run through all three kernels with finite logs")

    # No host synchronization inside the loop: any synchronizing CUDA call
    # in a short episode shows up here as a warning.
    import warnings

    args = warm_start(2)
    sync()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            warm(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"[6] host synchronizations in 5 control steps: {len(syncs)}", flush=True)
    if syncs:
        for where in sorted(set(syncs)):
            print(f"    {syncs.count(where)} x {where}")
        fail("the episode loop synchronizes the host with the card")

    n_prof = 20
    window, window_start = serving_episode(params, dev, n_prof)
    args = window_start(1)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window(*args)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # The wb_loop.* ranges also appear on the device timeline as annotations.
    ops = [e for e in events
           if e.device_type == DeviceType.CUDA and not e.key.startswith("wb_loop.")]
    dev_us = sum(e.self_device_time_total for e in ops)
    n_ops = sum(e.count for e in ops)
    if not dev_us:
        print("[6] profiler: device time not measured (no CUDA events)", flush=True)
        return launches, step_ms
    print(f"[6] profiler: device busy {dev_us / n_prof:.1f} us/control step; busy share "
          f"{dev_us / wall_us:.3f} of the profiled wall ({wall_us / n_prof:.1f} us/step), "
          f"{dev_us / n_prof / (step_ms * 1e3):.3f} of the unprofiled step; "
          f"{n_ops / n_prof:.0f} device ops/control step", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / n_prof:8.1f} us/step {e.count / n_prof:6.1f} "
              f"ops/step  {e.key[:90]}")
    parts = sorted((e for e in events
                    if e.key.startswith("wb_loop.") and e.device_type == DeviceType.CPU),
                   key=lambda e: -e.cpu_time_total)
    print("[6] host time per part (profiled, us/control step): " + ", ".join(
        f"{e.key[8:]} {e.cpu_time_total / n_prof:.0f}" for e in parts), flush=True)
    return launches, step_ms


def phase_reach(dev):
    """The reach gate on the card: converge (L1 of the commanded EE < 5 mm
    held 50 steps) and hold >= 99% of the steps after, for every seed."""
    params = wb.position_mode_params()
    run, start = serving_episode(params, dev, N_REACH)
    results = {}
    for seed in REACH_SEEDS:
        t0 = time.perf_counter()
        _, logs = run(*start(seed))
        l1_cmd, l1_meas = logs.l1_cmd.cpu().numpy(), logs.l1_meas.cpu().numpy()
        wall = time.perf_counter() - t0
        q = episode_quality(l1_cmd, l1_meas, tail_n=300)
        results[seed] = q
        print(f"[7] reach seed {seed}: converged step {q['converged_step']} | held "
              f"{q['held_fraction_after_converge']:.3f} after | first reach "
              f"{q['reach_gate_first_step']} | l1_cmd tail max {q['l1_cmd_tail_max_mm']:.2f} mm "
              f"(mean {q['l1_cmd_tail_mean_mm']:.2f}) | l1_meas tail max "
              f"{q['l1_meas_tail_max_mm']:.2f} mm (mean {q['l1_meas_tail_mean_mm']:.2f}) | "
              f"{wall:.1f} s wall", flush=True)
    bad = [s for s, q in results.items()
           if q["converged_step"] < 0 or q["held_fraction_after_converge"] < 0.99]
    if bad:
        fail(f"reach gate not met (converged and held >= 0.99) for seeds {bad}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    smi = phase_build(dev)
    errs = {"wb_cost": 0.0, "wb_update": 0.0, "plant_tick": 0.0}
    phase_kernels(dev, errs)
    phase_philox(dev)
    launches, solve_ms, serve = phase_serving(dev)
    t, bounds = phase_timing(dev)
    phase_profile(serve, solve_ms)
    t_plant, plant_bound = phase_plant(dev, errs)
    episode_launches, step_ms = phase_episode(dev)
    phase_reach(dev)
    kernels = [
        {"name": "wb_cost", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL}:575 _cost_kernel_store, {TPU_KERNEL}:564 _cost_kernel_noise",
         "launches": launches["wb_cost"], "max_abs_err": errs["wb_cost"],
         "ms": t["wb_cost"], "plain_ms": t["wb_cost_plain"],
         "bound_ms": bounds["wb_cost"][0], "bound_by": bounds["wb_cost"][1],
         "library_ms": None,
         "noise_ms": t["wb_cost_noise"], "noise_plain_ms": t["wb_cost_noise_plain"],
         "noise_bound_ms": bounds["wb_cost_noise"][0],
         "noise_bound_by": bounds["wb_cost_noise"][1],
         "episode_launches": episode_launches["wb_cost"]},
        {"name": "wb_update", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL}:655 _update_kernel_fused_noise (_fused_update_body :624)",
         "launches": launches["wb_update"], "max_abs_err": errs["wb_update"],
         "ms": t["wb_update"], "plain_ms": t["wb_update_plain"],
         "bound_ms": bounds["wb_update"][0], "bound_by": bounds["wb_update"][1],
         "library_ms": t["library_mv"], "episode_launches": episode_launches["wb_update"]},
        {"name": "plant_tick", "route": "cuda", "source": PLANT_SOURCE,
         "replaces": f"{PLANT_TPU_KERNEL}:116 make_plant_tick_kernel (kernel :137)",
         "launches": episode_launches["plant_tick"], "max_abs_err": errs["plant_tick"],
         "ms": t_plant["plant_tick"], "plain_ms": t_plant["plant_tick_plain"],
         "bound_ms": plant_bound[0], "bound_by": plant_bound[1], "library_ms": None,
         "b1024_ms": t_plant["plant_tick_b1024"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"serving solve {solve_ms:.4f} ms, serving episode {step_ms:.4f} ms/control step "
          f"on {smi}")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
