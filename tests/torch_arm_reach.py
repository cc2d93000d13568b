"""The arm-reach scenario of both packages over many seeds, on the CPU.

Runs ``scenarios/solvers.run_arm_reach`` of the JAX package (its jitted
episode) and of the port (``device="cpu"``) at the preset (K=100, H=32,
800 control steps) on each seed, and prints each seed's least and last L1
error of the commanded EE position, then per package the mean, the
standard deviation, the range and how many seeds reach the 0.10 m gate.
The two packages draw their noise from different generators (JAX keys,
Philox), so a seed names a different draw in each: the distributions are
compared, not the seeds.

Not collected by pytest (no ``test_`` prefix).  Usage:
    python tests/torch_arm_reach.py [--seeds 0-11] [--steps 800]
        [--package jax|port|both] [--out reach.json]
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GATE_M = 0.10  # chip_smoke.py phase 16: the commanded EE within 0.10 m at its best


def jax_reach(seed: int, steps: int) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from quadrotor_manipulator_mppi_tpu.scenarios import solvers

    out = {}
    solvers.finish = lambda name, metrics, logs, args: out.update(metrics)
    solvers.run_arm_reach(SimpleNamespace(seed=seed, steps=steps, resume=None, save_state=None,
                                          save_log=None, out=None))
    return out


def port_reach(seed: int, steps: int) -> dict:
    from quadrotor_manipulator_mppi_tpu_torch.scenarios.solvers import run_arm_reach

    return run_arm_reach(seed=seed, steps=steps, device="cpu")


def seeds_of(text: str) -> list:
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(x) for x in text.split(",")]


def summary(rows: list) -> dict:
    best = np.asarray([r["min_ee_err_m"] for r in rows])
    return {"n": len(rows), "mean_min_m": float(best.mean()), "std_min_m": float(best.std(ddof=1))
            if len(rows) > 1 else 0.0, "lo_min_m": float(best.min()), "hi_min_m": float(best.max()),
            "gate_met": int((best < GATE_M).sum()), "phase2": int(sum(r["phase2"] for r in rows))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-11")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--package", choices=("jax", "port", "both"), default="both")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "4")))
    runners = {"jax": jax_reach, "port": port_reach}
    names = ("jax", "port") if args.package == "both" else (args.package,)
    result = {}
    for name in names:
        rows = []
        for seed in seeds_of(args.seeds):
            t0 = time.perf_counter()
            r = {"seed": seed, **runners[name](seed, args.steps)}
            r["s"] = round(time.perf_counter() - t0, 1)
            print(json.dumps({"package": name, **r}), flush=True)
            rows.append(r)
        result[name] = {"seeds": rows, "summary": summary(rows)}
        print(json.dumps({"package": name, **result[name]["summary"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
