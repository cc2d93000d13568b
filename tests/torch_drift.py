"""Long-episode drift of the port's whole-body closed loop against the JAX
package's, on the CPU, with the solver noise shared.

The JAX episode runs on its own key chain; the port's episode is fed the
standard normals that chain draws (as ``z``), chunk by chunk, from the same
start.  Both use the default loop configuration (the per-substep RNEA
plant).  Printed: per chunk, the largest difference in the logged EE error,
base position and commanded L1; the first step at which each difference
passes ``--tol``; and the reach gate of both episodes (converged step,
held fraction after it).

``--against jax --perturb EPS`` runs a second JAX episode in place of the
port's, on the same key chain, from a start whose base is moved by EPS
metres along x: how fast the closed loop itself amplifies a difference of
rounding size, to set beside the port's drift.

Not collected by pytest (no ``test_`` prefix).  Usage:
    python tests/torch_drift.py [--mode attitude] [--k 512] [--h 50]
        [--steps 1000] [--chunk 50] [--seed 0] [--against port|jax]
        [--perturb 1e-6] [--out drift.json]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import torch  # noqa: E402

from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl  # noqa: E402
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwbs  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.evaluation.metrics import episode_quality  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twbs  # noqa: E402

from torch_parity import shared_z, to_port  # noqa: E402

FIELDS = ("ee_err", "base_pos", "l1_cmd")


def jax_params(mode: str, k: int, h: int):
    if mode == "position":
        return jwbs.position_mode_params(n_samples=k, n_horizon=h)
    if mode == "wrench":
        return jwbs.wrench_mode_params(n_samples=k, n_horizon=h)
    base = jwbs.WholeBodyMPPIParams()
    return dataclasses.replace(base, mppi=dataclasses.replace(base.mppi, n_samples=k,
                                                              n_horizon=h))


def main(argv=None) -> dict:
    """Runs the comparison, prints its JSON line and returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="attitude", choices=["position", "attitude", "wrench"])
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--h", type=int, default=50)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--against", default="port", choices=["port", "jax"])
    ap.add_argument("--perturb", type=float, default=1e-6)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    n, chunk = args.steps, args.chunk
    if n % chunk:
        raise SystemExit("--steps must be a multiple of --chunk")

    jp = jax_params(args.mode, args.k, args.h)
    jrun = jax.jit(jwbl.make_whole_body_episode(jp, cfg=jwbl.WholeBodyLoopConfig(),
                                                n_control_steps=chunk, low_k_guard="off"))
    _, jinit = jwbs.make_whole_body_solver(jp, low_k_guard="off")
    jobs = jwbs.default_obs()
    jcarry = (jwbl.init_plant(jp.model.vehicle), jinit(jax.random.key(args.seed)),
              jobs.ee_target, jobs.base_target)

    if args.against == "jax":
        plant = jcarry[0]
        moved = plant._replace(base=plant.base._replace(
            pos=plant.base.pos.at[0].add(args.perturb)))
        other = (moved, *jcarry[1:])

        def run_other(carry, z):
            carry, logs = jrun(*carry)
            return carry, {f: np.asarray(getattr(logs, f)) for f in FIELDS}

    tp = to_port(jp)
    run = wbl.make_whole_body_episode(tp, cfg=wbl.WholeBodyLoopConfig(), n_control_steps=chunk,
                                      low_k_guard="off", device="cpu", backend="torch")
    _, init = twbs.make_whole_body_solver(tp, device="cpu", low_k_guard="off")
    obs = twbs.default_obs(device="cpu")
    if args.against == "port":
        other = (wbl.init_plant(tp.model.vehicle, device="cpu"), init(args.seed),
                 obs.ee_target, obs.base_target)

        def run_other(carry, z):
            carry, logs = run(*carry, z=torch.from_numpy(z))
            return carry, {f: getattr(logs, f).numpy() for f in FIELDS}

    jl = {f: [] for f in FIELDS}
    tl = {f: [] for f in FIELDS}
    t0 = time.time()
    for c in range(n // chunk):
        key = jcarry[1].key
        z = np.zeros((chunk, args.k, args.h, 11), np.float32)
        for i in range(chunk):
            key, z[i] = shared_z(key, args.k, args.h)
        jcarry, jlogs = jrun(*jcarry)
        other, logs = run_other(other, z)
        for f in FIELDS:
            jl[f].append(np.asarray(getattr(jlogs, f)))
            tl[f].append(logs[f])
        d = {f: float(np.abs(jl[f][-1] - tl[f][-1]).max()) for f in FIELDS}
        print(f"steps {c * chunk}-{(c + 1) * chunk - 1}: max |diff| "
              + " ".join(f"{f} {v:.3e}" for f, v in d.items())
              + f" ({time.time() - t0:.0f} s)", flush=True)

    jl = {f: np.concatenate(v) for f, v in jl.items()}
    tl = {f: np.concatenate(v) for f, v in tl.items()}
    diff = {f: np.abs(jl[f] - tl[f]).reshape(n, -1).max(axis=1) for f in FIELDS}
    first = {f: int(np.argmax(diff[f] > args.tol)) if (diff[f] > args.tol).any() else -1
             for f in FIELDS}
    jq = episode_quality(jl["l1_cmd"], jl["l1_cmd"], tail_n=min(300, n))
    tq = episode_quality(tl["l1_cmd"], tl["l1_cmd"], tail_n=min(300, n))
    result = {
        "against": args.against, "perturb": args.perturb if args.against == "jax" else 0.0,
        "mode": args.mode, "k": args.k, "h": args.h, "steps": n, "seed": args.seed,
        "tol": args.tol, "first_step_over_tol": first,
        "max_diff": {f: float(v.max()) for f, v in diff.items()},
        "diff_at": {str(s): {f: float(diff[f][s]) for f in FIELDS}
                    for s in (0, 9, 49, 99, 199, 299, 499, 999) if s < n},
        "jax": {"converged_step": jq["converged_step"],
                "held": jq["held_fraction_after_converge"],
                "base_exc_max_m": float(np.linalg.norm(
                    jl["base_pos"] - np.asarray(jobs.base_target), axis=-1).max())},
        "other": {"converged_step": tq["converged_step"],
                 "held": tq["held_fraction_after_converge"],
                 "base_exc_max_m": float(np.linalg.norm(
                     tl["base_pos"] - obs.base_target.numpy(), axis=-1).max())},
        "wall_s": time.time() - t0,
    }
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return result


if __name__ == "__main__":
    main()
