"""Scenario x sample weak-scaling efficiency of the whole-body solve (the
>= 85% multi-device target); the measurement core is
``parallel/scaling.measure_weak_scaling``.

Port of the JAX package's ``scenarios/scaling.py``.  Where the JAX runner
measures over the devices of one process, the port runs one process per
rank of a ``torch.distributed`` world: ``nccl`` with one card per rank on
the card, ``gloo`` ranks on the CPU.  One rank runs in this process; more
are started as child processes on a free localhost port, each bounded by a
timeout and all killed if one fails.  The solve runs on the kernels
(``backend="cuda"``) on the card and on the plain pipeline
(``backend="torch"``) on the CPU, as the JAX runner passes ``"pallas"``
and ``"xla"``.

    python -m quadrotor_manipulator_mppi_tpu_torch.scenarios.scaling \\
        <init_method> <rank> <world> <k_per_device> <iters> <device>

is one rank (it prints its result as one JSON line).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RANK_TIMEOUT_S = 600.0   # a child rank's whole run
CPU_NOTE = ("CPU ranks share one machine's cores: these efficiencies lower-bound the "
            "plumbing only; the >=85% target is judged on real multi-card hardware")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def measure_rank(init_method: str, rank: int, world: int, k_per_device: int, iters: int,
                 device) -> dict:
    """One rank's ``measure_weak_scaling`` in a world of ``world`` ranks
    (``nccl`` on a card, ``gloo`` on the CPU), the group destroyed after."""
    from ..parallel.scaling import measure_weak_scaling

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        return measure_weak_scaling(k_per_device=k_per_device, iters=iters, device=dev,
                                    backend="cuda" if on_card else "torch")
    finally:
        dist.destroy_process_group()


def _spawn_ranks(n: int, k_per_device: int, iters: int, device: torch.device) -> dict:
    """``n`` ranks as child processes; rank 0's result."""
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, init_method, str(r), str(n), str(k_per_device),
         str(iters), f"cuda:{r}" if device.type == "cuda" else "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"a bench-scaling rank exited {p.returncode}:\n"
                                   + err.decode(errors="replace")[-4000:])
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return json.loads(outs[0].strip().splitlines()[-1])


def run_bench_scaling(device="cuda", devices: int = 8, k_per_device: int = 2048,
                      iters: int = 10) -> dict:
    """Weak scaling of the whole-body solve over the sample axis and over
    the scenario axis, on ``devices`` ranks: clamped to the cards there
    are on the card, ``devices`` gloo ranks on the CPU.  Returns rank 0's
    measurement (``parallel/scaling.measure_weak_scaling``) with the
    platform, and on the CPU the note that its efficiencies bound only the
    plumbing.  The solves draw under fixed seeds, as the JAX measurement's
    do."""
    dev = resolve_device(device)
    n = min(devices, torch.cuda.device_count()) if dev.type == "cuda" else devices
    if n < 1:
        raise ValueError(f"bench-scaling needs at least one rank, got {devices}")
    if n == 1:
        out = measure_rank(f"tcp://127.0.0.1:{_free_port()}", 0, 1, k_per_device, iters, dev)
    else:
        out = _spawn_ranks(n, k_per_device, iters, dev)
    out = {"platform": dev.type, **out}
    if dev.type == "cpu":
        out["note"] = CPU_NOTE
    return out


if __name__ == "__main__":
    init, rank, world, k, iters, device = sys.argv[1:7]
    if device == "cpu":
        torch.set_num_threads(1)
    print(json.dumps(measure_rank(init, int(rank), int(world), int(k), int(iters), device)),
          flush=True)
