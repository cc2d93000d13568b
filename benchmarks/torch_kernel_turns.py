"""Time ``plant_tick`` and ``drone_update`` of two checkouts of the port in
turns on one card, and compare their outputs.

    python3 benchmarks/torch_kernel_turns.py PARENT_DIR [--out FILE]

``PARENT_DIR`` is another checkout of the repository (for example the
parent commit unpacked with ``git archive``).  The script runs four turns,
parent, this checkout, this checkout, parent, each in a fresh process whose
working directory and import path are that checkout, so each builds and
loads its own kernels.  A turn makes the same inputs from fixed seeds, runs
each kernel once and saves its outputs, then times each kernel by CUDA-graph
replay (20 calls per graph, median of 5 replays): ``plant_tick`` at B=1 and
B=1024, both ``drone_update`` variants at the shapes of ``chip_smoke.py``'s
drone sweep, and ``torch.mv`` of the noise by the weights beside the read
variant.  It also runs three unbatched steps of the drone preset
(``make_drone_solver``, K=1000, H=32, on the Philox stream) and saves their
plans, timed on the host clock.  Then it prints, per kernel and shape, the
four turns' times and the largest difference between the two checkouts'
outputs (0.0 when they are bit-equal), and writes all of it as JSON to
``FILE``.  Needs one CUDA card and ``nvcc``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

DRONE_SIZES = ((1000, 32), (1024, 32), (4096, 32), (16384, 32), (16384, 100))
PLANT_ROWS = (1, 1024)


def graph_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def worker(out_path: str) -> None:
    """One turn, in the checkout that is the working directory."""
    import numpy as np
    import torch

    from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
    from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import drone_kernel as dk
    from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk
    from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
    from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb

    dev = torch.device("cuda", 0)
    outputs, times = {}, {}
    model = wb.position_mode_params().model
    pc = pk.make_plant_config(model.vehicle, fc.FlightGains(), model.chain(),
                              extra_mass=model.arm_mass_lump)
    for rows in PLANT_ROWS:
        args = pk.sample_rows(model.vehicle, model.chain(), model.inertials(), rows, seed=rows,
                              device=dev)
        outputs[f"plant_tick_b{rows}"] = pk.plant_tick(pc, *args).cpu().numpy()
        times[f"plant_tick_b{rows}"] = graph_ms(torch, lambda: pk.plant_tick(pc, *args))
    for k, h in DRONE_SIZES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 * k + h)
        noise = 30.0 * torch.randn((k, h, 3), generator=gen, device=dev)
        w = torch.softmax(torch.randn(k, generator=gen, device=dev) * 3.0, dim=0)
        keys = sampling.philox_keys(2**36 + 1000 * k + h, dev)
        flat = noise.view(k, h * 3).t()
        cases = {"drone_update": lambda: dk.drone_update(w, keys, h, 3, 30.0),
                 "drone_update_noise": lambda: dk.drone_update_noise(noise, w),
                 "torch_mv": lambda: torch.mv(flat, w)}
        for name, fn in cases.items():
            outputs[f"{name}_k{k}_h{h}"] = fn().cpu().numpy()
            times[f"{name}_k{k}_h{h}"] = graph_ms(torch, fn)
    from quadrotor_manipulator_mppi_tpu_torch.solver import drone

    step, init = drone.make_drone_solver(device=dev)
    obs = drone.DroneObs(x=torch.tensor([0.1, -0.2, 1.0], device=dev),
                         v=torch.tensor([0.0, 0.3, 0.0], device=dev),
                         target=torch.tensor(drone.DEFAULT_TARGET, device=dev))
    state = init(21)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plans = []
    for _ in range(3):
        out, state = step(state, obs)
        plans.append(out.u_seq)
    torch.cuda.synchronize()
    times["drone_preset_3_steps_host"] = (time.perf_counter() - t0) * 1e3 / 3
    outputs["drone_preset_3_steps_host"] = torch.stack(plans).cpu().numpy()
    np.savez(out_path, **outputs)
    with open(out_path + ".json", "w") as f:
        json.dump({"times": times, "device": torch.cuda.get_device_name(0)}, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--out", default="build/torch_kernel_turns.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return
    import numpy as np

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("parent", "change", "change", "parent")):
            path = os.path.join(tmp, f"turn{i}.npz")
            env = dict(os.environ, PYTHONPATH=trees[name])
            subprocess.run([sys.executable, os.path.abspath(__file__), trees[name], "--worker",
                            path], cwd=trees[name], env=env, check=True)
            with open(path + ".json") as f:
                turns.append((name, dict(np.load(path)), json.load(f)["times"]))
        report = {"device": smi, "turns": [n for n, _, _ in turns], "kernels": {}}
        for key in turns[0][2]:
            diff = float(np.abs(turns[0][1][key].astype(np.float64)
                                - turns[1][1][key].astype(np.float64)).max())
            report["kernels"][key] = {"ms": [t[2][key] for t in turns],
                                      "max_abs_diff_parent_vs_change": diff}
            print(f"{key}: ms " + " / ".join(f"{n} {t[key]:.5f}" for n, _, t in turns)
                  + f" | max|parent - change| {diff:.3g}", flush=True)
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
