"""The traced slice of a ``--trace 1`` run and what the per-layer readers get.

After the measured window, the harness runs a few more calls (requests,
or one short episode) under ``torch.profiler`` with the CPU and CUDA
activities, inside the benchmark's own ``record_function`` ranges
(``portbench.*``).  :func:`collect` reduces the profiler's events to device
operations (kernels, copies, sets: name, start, duration) and the
benchmark's host spans, on the profiler's one clock.  The profiler slows
the host 2-3x (it records every kernel of a graph as the graph launches),
so what the host's pace sets is read from the untraced window instead:
each call's enqueue time (host clock) and the device time of each call
(CUDA events, ``runner.CallSpans``).  :class:`Context` is what each reader
in ``metrics/`` receives.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import re
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT_CSRC = ROOT / "quadrotor_manipulator_mppi_tpu_torch" / "csrc"
SPAN_PREFIX = "portbench."
# Host ranges that the profiler also draws on the device timeline.
_ANNOTATION_PREFIXES = (SPAN_PREFIX, "wb_loop.", "episode.", "loop.", "arm_loop.", "ProfilerStep")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernels() -> tuple:
    """The names of the port's hand-written CUDA kernels, read from its
    sources (every ``__global__`` function under ``csrc/``)."""
    names = set()
    for src in sorted(PORT_CSRC.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return tuple(sorted(names))


def kernel_pattern(names) -> re.Pattern:
    """Matches a device op's name that is one of the kernels ``names``
    (a demangled name: ``void wb_cost_kernel<0, true, true>(...)``)."""
    return re.compile(r"\b(?:" + "|".join(re.escape(n) for n in names) + r")\s*[<(]")


def op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def collect(prof) -> dict:
    """Device ops [(name, start_ns, dur_ns, kind)] and benchmark spans
    [(name, start_ns, end_ns)] of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(_ANNOTATION_PREFIXES):
                continue
            ops.append((name, e.start_ns(), e.duration_ns(), op_kind(name)))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
    ops.sort(key=lambda o: o[1])
    return {"ops": ops, "spans": spans}


def merged(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _load(path: Path, what: str):
    if not path.exists():
        raise SystemExit(f"no {what} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{what}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader ``metrics/<name>.py`` (its ``read(ctx)``)."""
    return _load(HERE / "metrics" / f"{name}.py", "metric")


def load_stage(name: str):
    """The work count ``work/<name>.py``: its ``KERNELS`` and ``work(shape)``,
    a list of ways to do the stage's work ({"flops", "bytes"}), of which the
    cheapest at the peaks sets the least time."""
    return _load(HERE / "work" / f"{name}.py", "stage")


class Context:
    """What a per-layer reader sees of one traced run.

    Of the traced slice: ``ops``, its device operations clipped to its span
    ``traced`` (``slice_ns``, the profiler's clock), and ``units``, the
    calls (requests, batched calls) or control steps in it.  Of the measured
    window: ``enqueue_s``, the host seconds of each call into the port
    before its readback, and ``window_busy_s`` / ``window_s``, the device
    time of its calls (None without a card) and its length.  ``shape``: the
    cell's sizes (``B``, ``K``, ``H``, ``A``, ``mode``, ``substeps``);
    ``peaks``: ``peaks.json``."""

    def __init__(self, traced: dict, units: int, shape: dict, enqueue_s: list, window: tuple,
                 device_kind: str):
        spans = {sp[0]: sp for sp in traced["spans"]}
        t0, t1 = (spans["traced"][1], spans["traced"][2]) if "traced" in spans else (0, 1 << 62)
        self.slice_ns = (t0, t1)
        self.ops = [o for o in traced["ops"] if o[1] + o[2] > t0 and o[1] < t1]
        self.units, self.shape, self.enqueue_s = units, shape, enqueue_s
        self.window_busy_s, self.window_s = window
        port = port_kernels()
        self.port_re = kernel_pattern(port) if port else None
        peaks = json.loads((HERE / "peaks.json").read_text())
        self.peaks = peaks.get(device_kind) or peaks["NVIDIA H100 80GB HBM3"]

    # -- device time
    def busy_ns(self) -> int:
        """The slice's time in which some device op ran (the union of their
        intervals)."""
        t0, t1 = self.slice_ns
        return sum(e - s for s, e in merged((max(o[1], t0), min(o[1] + o[2], t1))
                                            for o in self.ops))

    def kernels(self):
        return [o for o in self.ops if o[3] == "kernel"]

    def time_s(self, names) -> Optional[float]:
        """Device seconds of the kernels ``names``; None where none ran."""
        pat = kernel_pattern(names)
        hits = [o[2] for o in self.kernels() if pat.search(o[0])]
        return sum(hits) * 1e-9 if hits else None

    def glue_s(self) -> Optional[float]:
        """Device seconds of the kernels that are not the port's own."""
        hits = [o[2] for o in self.kernels() if not (self.port_re and self.port_re.search(o[0]))]
        return sum(hits) * 1e-9 if hits else None

    def roofline_share(self, stage: str) -> Optional[float]:
        """The stage's least time at the peaks (``work/<stage>.py``: the larger
        of operations over the float32 rate and bytes over the bandwidth, for
        the cheapest way it lists) over the device time of its kernels, per
        unit, in %; None where none ran."""
        mod = load_stage(stage)
        t = self.time_s(mod.KERNELS)
        if not t:
            return None
        least = min(max(w["flops"] / self.peaks["fp32_flops_per_s"],
                        w["bytes"] / self.peaks["hbm_bytes_per_s"]) for w in mod.work(self.shape))
        return 100.0 * least * self.units / t


def top_ops(ops: list) -> list:
    """The ten device ops that took most time, by name: [[name, seconds]]."""
    by_name = {}
    for name, _, dur, _ in ops:
        key = name[:160]
        by_name[key] = by_name.get(key, 0) + dur
    return [[k, v * 1e-9] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]


def idle_gaps_by_span(traced: dict) -> list:
    """The ten host spans in which the device sat idle longest, in the slice
    whose host activity was recorded (its span ``traced``): [[span, seconds]]."""
    spans = {sp[0]: sp for sp in traced["spans"]}
    if "traced" not in spans:
        return []
    t0, t1 = spans["traced"][1], spans["traced"][2]
    busy = merged((max(o[1], t0), min(o[1] + o[2], t1)) for o in traced["ops"]
                  if o[1] + o[2] > t0 and o[1] < t1)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    # The calls' spans do not overlap; "traced" holds them all.
    inner = sorted((sp for sp in traced["spans"] if sp[0] != "traced"), key=lambda sp: sp[1])
    starts = [sp[1] for sp in inner]
    idle = {}
    for s, e in gaps:
        j = bisect.bisect_right(starts, s) - 1
        name = inner[j][0] if j >= 0 and s < inner[j][2] else "between calls"
        idle[name] = idle.get(name, 0) + (e - s)
    longest = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return [[k, v * 1e-9] for k, v in longest]
