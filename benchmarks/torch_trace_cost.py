"""What the port's tracer costs on one card, with it off and on.

    python3 benchmarks/torch_trace_cost.py [--out FILE]

Builds the packed serving solve of the flagship preset (attitude, K=4096,
H=50) and the whole-body fleet episode (position mode, B=256, K=512,
H=50, the plant kernel) twice in one process: once with no tracer (the
graphs hold the step's nodes alone) and once inside
``utils.profiling.tracing`` (the graphs hold the stage marks, and every
call opens the host spans).  In turns, off, on, on, off, it times:

* serving calls back to back (the inputs loaded, the replay, the reply
  copied), CUDA events over 200 calls: device ms per call, and the stamped
  graph's own per-call span (``graph.begin`` -> ``graph.end``);
* a serving call with its readback (the inputs loaded, the replay, the
  reply copied and read back), host clock over 200 calls, with a tracer
  installed on the "on" turns: ms per request;
* one 40-step fleet episode call, CUDA events: device ms per control step
  (the episode's carry and log copies included), and the stamped step's
  span;
* ``profiling.span`` with no tracer and with one, host clock: ns per span;
* ``%globaltimer``'s steps between marks launched back to back.

Prints one JSON line (the card's name and power limit beside the numbers)
and writes it to ``FILE``.  Needs one CUDA card and ``nvcc``.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import serving  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb  # noqa: E402
from quadrotor_manipulator_mppi_tpu_torch.utils import profiling  # noqa: E402

CALLS = 200
STEPS = 40
FLEET = 256


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def events_ms(fn, n: int) -> float:
    """Device ms per call of ``n`` calls of ``fn`` back to back."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


class Serve:
    def __init__(self, dev):
        self.pstep, pinit = serving.make_packed_step(wb.WholeBodyMPPIParams(), device=dev)
        self.vecs = serving.pack_obs(wb.default_obs(device=dev))
        self.carry = pinit(0)
        self.call()  # the capture
        self.call()

    def call(self):
        out, self.carry = self.pstep(self.carry, *self.vecs)
        return out

    def call_ms(self) -> float:
        return events_ms(self.call, CALLS)

    def request_ms(self) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            self.call().cpu()
        return (time.perf_counter() - t0) * 1e3 / CALLS


class Fleet:
    def __init__(self, dev):
        params = wb.position_mode_params(n_samples=512, n_horizon=50)
        cfg = wbl.WholeBodyLoopConfig(arm_coeffs_per_control=True, plant_kernel=True)
        self.run = wbl.make_whole_body_episode(params, cfg=cfg, n_control_steps=STEPS,
                                               device=dev, low_k_guard="off",
                                               n_scenarios=FLEET)
        self.starts = wbl.fleet_starts(params, FLEET, seed=0, device=dev)
        self.call()  # the capture

    def call(self):
        return self.run(*self.starts)

    def step_ms(self) -> float:
        return events_ms(self.call, 1) / STEPS


def span_ns(n: int = 100000) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.span("cost"):
            pass
    return (time.perf_counter_ns() - t0) / n


def timer_steps(dev, n: int = 500) -> dict:
    """``%globaltimer`` as the marks see it: ``n`` pairs of marks launched
    back to back (eagerly); the smallest nonzero step between two stamps
    and the greatest common divisor of every stamp's distance from the
    first (the timer's tick, if it is coarser than a nanosecond)."""
    import numpy as np

    with profiling.tracing(dev) as tracer:
        for _ in range(n):
            profiling.mark("tick.a")
            profiling.mark("tick.b")
        stamps = np.sort(tracer.read()["rows"].ravel())
    steps = np.diff(stamps)
    return {"min_step_ns": int(steps[steps > 0].min()),
            "tick_ns": int(np.gcd.reduce(stamps - stamps[0])),
            "median_step_ns": float(np.median(steps))}


def stamped_span_ms(tracer) -> float:
    rec = tracer.read()
    col = {m: i for i, m in enumerate(rec["marks"])}
    rows = rec["rows"]
    b, e = rows[:, col["graph.begin"]], rows[:, col["graph.end"]]
    ok = (b > 0) & (e > 0)
    return float((e - b)[ok].mean()) * 1e-6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    off = {"serve": Serve(dev), "fleet": Fleet(dev)}
    with profiling.tracing(dev) as tracer:
        on = {"serve": Serve(dev), "fleet": Fleet(dev)}
    times = {k: [] for k in ("serve_off", "serve_on", "request_off", "request_on",
                             "fleet_off", "fleet_on", "serve_span", "fleet_span")}
    for side in ("off", "on", "on", "off"):
        objs, stamped = (off, False) if side == "off" else (on, True)
        tracer.reset()
        times[f"serve_{side}"].append(objs["serve"].call_ms())
        if stamped:
            times["serve_span"].append(stamped_span_ms(tracer))
        # The host spans record into a tracer installed for the turn; the
        # stamped graphs' marks go to the ring of the one they were captured
        # under.
        with profiling.tracing(dev) if stamped else contextlib.nullcontext():
            times[f"request_{side}"].append(objs["serve"].request_ms())
        tracer.reset()
        times[f"fleet_{side}"].append(objs["fleet"].step_ms())
        if stamped:
            times["fleet_span"].append(stamped_span_ms(tracer))
    spans = {"off": span_ns()}
    with profiling.tracing(dev):
        spans["on"] = span_ns()
    out = {"card": card(), "calls": CALLS, "steps": STEPS, "fleet": FLEET,
           "ms": {k: [round(x, 6) for x in v] for k, v in times.items()},
           "median_ms": {k: statistics.median(v) for k, v in times.items()},
           "marks_per_call": {"serve": 5, "fleet": 11},
           "span_ns": spans, "calibration": tracer.calibrations,
           "globaltimer": timer_steps(dev)}
    med = out["median_ms"]
    out["cost_us_per_mark"] = {
        "serve": (med["serve_on"] - med["serve_off"]) * 1e3 / 5,
        "fleet": (med["fleet_on"] - med["fleet_off"]) * 1e3 / 11}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
