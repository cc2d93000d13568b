"""Timing and tracing helpers.

A solve-rate timer with percentile stats (the solves/s and 100 Hz budget
metrics of the JAX package's ``SolveTimer``), a steady-state timer of a
callable, and a ``torch.profiler`` session that writes a Chrome trace
(open it in Perfetto or ``chrome://tracing``).

CUDA launches return before the card finishes, so every clock here stops
only after the card has finished the work it timed: :func:`block_until_ready`
synchronises the device of each CUDA tensor in a result tree.

The tracer (:class:`Tracer`, installed by :func:`tracing`) names where a
step's time goes, inside a CUDA graph as well as eagerly.  It is off by
default: with none installed, :func:`mark` and :func:`span` do nothing.

* :func:`mark` ``(name)`` stamps a point in stream order.  On the card it
  launches a one-thread kernel (``csrc/trace_mark.cu``) that writes the
  card's ``%globaltimer`` into a ring on the card; inside a capture it
  becomes a node of the graph, so every replay stamps it.  On the CPU,
  where eager ops run as they are called, it writes ``perf_counter_ns``
  into a host ring of the same layout.  One row per call: a mark whose
  column in the current row is already stamped starts the next row.
* :func:`span` ``(name)`` is a host span (name, start, end, parent) on
  ``perf_counter_ns``.
* :meth:`Tracer.calibrate` maps the card's clock onto the host's, so that
  a device stamp can be set beside the host spans.

Marks and spans open a ``record_function`` of the same name only while a
``torch.profiler`` session is active, so a profile of the eager path keeps
the stage names.  Everything stays in memory (:meth:`Tracer.read`).

Stage marks: ``graph.begin`` / ``graph.end`` (around a captured step,
``utils/graphs``); ``solve.cost`` / ``solve.update`` / ``solve.tail`` (the
kernel solve, ``ops/cuda/whole_body_kernel``); ``wb_loop.solve``,
``wb_loop.servo``, ``wb_loop.arm_dynamics``, ``wb_loop.carrot``,
``wb_loop.contact``, ``wb_loop.tick``, ``wb_loop.logs`` (the whole-body
control step, ``sim/whole_body_loop``).  Host spans: ``graphs.capture``,
``graphs.load``, ``graphs.replay`` (``utils/graphs``), ``serving.reply``
(``solver/serving``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from .device import resolve_device


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree: Any) -> Any:
    """Wait for the card to finish the work behind every CUDA tensor in
    ``tree`` (tensors, tuples, NamedTuples, lists, dicts); returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


@dataclass
class SolveTimer:
    """Collects per-solve wall times (seconds)."""

    times: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, result_to_block=None):
        """Time the block; with ``result_to_block`` (a result tree) the clock
        stops after the card has finished it."""
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            block_until_ready(result_to_block)
        self.times.append(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    def stats(self) -> dict:
        t = np.asarray(self.times)
        if t.size == 0:
            return {}
        return {
            "n": int(t.size),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
            "solves_per_s": float(1.0 / t.mean()),
            # The real-time budget: a solve under 10 ms for 100 Hz control.
            "meets_100hz_budget": bool(np.percentile(t, 99) < 0.010),
        }


def time_fn(fn: Callable, *args, iters: int = 50, warmup: int = 3) -> dict:
    """Steady-state timing of ``fn(*args)``: ``warmup`` calls, then ``iters``
    timed calls, each blocking on its result."""
    timer = SolveTimer()
    out = None
    for _ in range(warmup):
        out = fn(*args)
    block_until_ready(out)
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        timer.record(time.perf_counter() - t0)
    return timer.stats()


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """``torch.profiler`` session over the block; on exit it writes a
    Chrome trace to ``<log_dir>/trace.json`` and yields that path.

    With ``device="cuda"`` it records the card's activity (kernels, copies)
    beside the host's and raises when no card is present; ``device="cpu"``
    records the host alone.  A tracer is installed for the block, so the
    eager parts of what it profiles keep their stage names."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with tracing(dev) as tracer, torch.profiler.profile(activities=acts) as prof:
        yield path
        tracer.close_ranges()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

MAX_MARKS = 32      # mark names per tracer: the kernel's template instances
RING_ROWS = 4096    # calls or steps the ring holds; older rows are overwritten
CALIBRATION_PAIRS = 100

_current: Optional["Tracer"] = None
_NO_SPAN = contextlib.nullcontext()


def current() -> Optional["Tracer"]:
    """The installed tracer, or None."""
    return _current


def mark(name: str) -> None:
    """Stamp the stage mark ``name`` in stream order (nothing without a
    tracer)."""
    t = _current
    if t is not None:
        t.mark(name)


def span(name: str):
    """The host span ``name`` over a ``with`` block (a shared no-op context
    without a tracer)."""
    t = _current
    return _NO_SPAN if t is None else t.span(name)


@contextlib.contextmanager
def tracing(device="cuda"):
    """Install a new :class:`Tracer` on ``device`` for the block and yield
    it; the one installed before comes back on exit.  On the card the first
    tracer of the process builds ``csrc/trace_mark.cu``.  A graph captured
    while it is installed keeps it alive (its marks write into its ring)."""
    global _current
    tracer = Tracer(device)
    prev, _current = _current, tracer
    try:
        yield tracer
    finally:
        tracer.close_ranges()
        _current = prev


def _profiler_on() -> bool:
    return torch._C._autograd._profiler_enabled()


@functools.lru_cache(maxsize=None)
def _mark_lib() -> ctypes.CDLL:
    from ..ops.cuda import build

    lib = build.load_library("trace_mark")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.trace_mark_launch.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.trace_mark_launch.restype = ci
    lib.trace_mark_pairs.argtypes = [vp, vp, ci, vp, vp]
    lib.trace_mark_pairs.restype = ci
    return lib


class _Span:
    __slots__ = ("tracer", "name", "id", "parent", "start", "range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t = self.tracer
        stack = t._open_spans()
        self.parent = stack[-1] if stack else None
        with t._lock:
            t._next_span += 1
            self.id = t._next_span
        stack.append(self.id)
        self.range = None
        if _profiler_on():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        t = self.tracer
        t._open_spans().pop()
        with t._lock:
            t.spans.append((self.id, self.name, self.start, end, self.parent))
            t.calls[self.name] = t.calls.get(self.name, 0) + 1
        return False


class Tracer:
    """Stage marks, host spans and counters of one tracing session.

    ``device``: where the marks are stamped (the card's ``%globaltimer``,
    or the host's ``perf_counter_ns`` on the CPU), into a ring of
    :data:`RING_ROWS` rows, one per call or step.  Counters: ``captures``
    and ``capture_s`` (the graphs captured while it was installed, warm-up
    included) and ``calls``, the spans closed per name.  ``spans``: (id, name, start_ns,
    end_ns, parent id or None) on the host clock, in the order they
    closed."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.rows = RING_ROWS
        self.names: List[str] = []
        self._ids: dict = {}
        self.spans: list = []
        self.calls: dict = {}
        self.captures = 0
        self.capture_s = 0.0
        self.calibrations: list = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_span = 0
        self._ranges: list = []  # [(group, record_function)] opened by marks
        if self.cuda:
            self._lib = _mark_lib()
            self._ring = torch.zeros((self.rows, MAX_MARKS), dtype=torch.int64,
                                     device=self.device)
            self._row = torch.zeros(1, dtype=torch.int64, device=self.device)
            self._cal = torch.zeros((CALIBRATION_PAIRS, 1), dtype=torch.int64,
                                    device=self.device)
            self._cal_row = torch.zeros(1, dtype=torch.int64, device=self.device)
        else:
            self._ring = np.zeros((self.rows, MAX_MARKS), dtype=np.int64)
            self._row = 0
        self.calibrate()

    # -- marks
    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            with self._lock:
                i = self._ids.get(name)
                if i is None:
                    if len(self.names) == MAX_MARKS:
                        raise ValueError(f"a tracer holds at most {MAX_MARKS} mark names")
                    i = self._ids[name] = len(self.names)
                    self.names.append(name)
        return i

    def mark(self, name: str) -> None:
        """Stamp ``name`` at the current row (see the module docstring)."""
        i = self._id(name)
        if _profiler_on():
            self._open_range(name)
        elif self._ranges:
            self.close_ranges()
        if self.cuda:
            rc = self._lib.trace_mark_launch(self._ring.data_ptr(), self._row.data_ptr(),
                                             self.rows, MAX_MARKS, i,
                                             torch.cuda.current_stream(self.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"trace_mark launch failed with CUDA error {rc}")
            return
        with self._lock:
            slot = self._ring[self._row % self.rows]
            if slot[i]:
                self._row += 1
                slot = self._ring[self._row % self.rows]
                slot[:] = 0
            slot[i] = time.perf_counter_ns()

    def _open_range(self, name: str) -> None:
        """Under a profiler, a mark opens a range of its name that lasts to
        the next mark of its group (the name before its last dot), which
        closes it and every range opened inside it; a mark named ``*.end``
        only closes."""
        group = name.rsplit(".", 1)[0]
        for j, (g, _) in enumerate(self._ranges):
            if g == group:
                for _, rf in reversed(self._ranges[j:]):
                    rf.__exit__(None, None, None)
                del self._ranges[j:]
                break
        if not name.endswith(".end"):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._ranges.append((group, rf))

    def close_ranges(self) -> None:
        """Close the ranges that marks opened under a profiler."""
        for _, rf in reversed(self._ranges):
            rf.__exit__(None, None, None)
        self._ranges.clear()

    # -- spans
    def _open_spans(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str) -> _Span:
        """The host span ``name`` over a ``with`` block."""
        return _Span(self, name)

    # -- clocks
    def calibrate(self) -> dict:
        """Set the marks' clock beside the host's: :data:`CALIBRATION_PAIRS`
        marks, each between a host stamp before its launch and one as soon
        as the card has run it (``trace_mark_pairs``, on the host's
        ``CLOCK_MONOTONIC``, which ``perf_counter_ns`` reads); the tightest
        pair gives the offset (device ns less host ns, at its midpoint) and
        half its width the error bound.  On the CPU the marks are on the
        host clock (offset and error 0).  Returns {host_ns, offset_ns,
        error_ns}, also kept in ``calibrations``."""
        if not self.cuda:
            cal = {"host_ns": time.perf_counter_ns(), "offset_ns": 0, "error_ns": 0}
            self.calibrations.append(cal)
            return cal
        if time.get_clock_info("perf_counter").implementation != \
                "clock_gettime(CLOCK_MONOTONIC)":
            raise RuntimeError("calibrate needs perf_counter on CLOCK_MONOTONIC")
        self._cal.zero_()
        self._cal_row.zero_()
        host = np.zeros((CALIBRATION_PAIRS, 2), dtype=np.int64)
        rc = self._lib.trace_mark_pairs(self._cal.data_ptr(), self._cal_row.data_ptr(),
                                        CALIBRATION_PAIRS,
                                        torch.cuda.current_stream(self.device).cuda_stream,
                                        host.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"trace_mark_pairs failed with CUDA error {rc}")
        stamps = self._cal[:, 0].cpu().numpy()
        best = int(np.argmin(host[:, 1] - host[:, 0]))
        t0, t1 = int(host[best, 0]), int(host[best, 1])
        mid = (t0 + t1) // 2
        cal = {"host_ns": mid, "offset_ns": int(stamps[best]) - mid,
               "error_ns": (t1 - t0 + 1) // 2}
        self.calibrations.append(cal)
        return cal

    # -- records
    def reset(self) -> None:
        """Forget the marks and spans recorded so far (not the counters)."""
        with self._lock:
            self.spans.clear()
            if self.cuda:
                self._ring.zero_()
                self._row.zero_()
            else:
                self._ring[:] = 0
                self._row = 0

    def read(self) -> dict:
        """Everything recorded, on the host (the card synchronised first).

        ``marks``: the names, ``rows``: an (n_rows, n_names) int64 array of
        stamps in ns, oldest row first (0: not stamped), ``clock``
        ``"device"`` or ``"host"``; ``spans``, ``calls``, ``captures``,
        ``capture_s``; ``calibrations``, the one at install and a new one
        (:meth:`calibrate`), which map a device stamp onto the host clock
        (:func:`to_host_ns`)."""
        self.calibrate()
        if self.cuda:
            ring, row = self._ring.cpu().numpy(), int(self._row.item())
        else:
            ring, row = self._ring.copy(), self._row
        n = min(row + 1, self.rows) if ring[row % self.rows].any() else min(row, self.rows)
        order = [(row - n + 1 + j) % self.rows for j in range(n)] if n else []
        with self._lock:
            return {"marks": list(self.names), "rows": ring[order][:, :len(self.names)],
                    "clock": "device" if self.cuda else "host",
                    "spans": list(self.spans), "calls": dict(self.calls),
                    "captures": self.captures, "capture_s": self.capture_s,
                    "calibrations": list(self.calibrations)}


def to_host_ns(stamps, calibrations) -> np.ndarray:
    """Device stamps (ns) on the host clock: less the calibrations' offset,
    interpolated linearly between the first and the last (the two clocks'
    drift), held at the ends."""
    d = np.asarray(stamps, dtype=np.float64)
    first, last = calibrations[0], calibrations[-1]
    d0, d1 = first["host_ns"] + first["offset_ns"], last["host_ns"] + last["offset_ns"]
    if d1 == d0:
        off = np.full_like(d, first["offset_ns"])
    else:
        w = np.clip((d - d0) / (d1 - d0), 0.0, 1.0)
        off = first["offset_ns"] + w * (last["offset_ns"] - first["offset_ns"])
    return d - off
