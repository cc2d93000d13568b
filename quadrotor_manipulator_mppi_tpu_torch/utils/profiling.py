"""Timing and tracing helpers.

A solve-rate timer with percentile stats (the solves/s and 100 Hz budget
metrics of the JAX package's ``SolveTimer``), a steady-state timer of a
callable, and a ``torch.profiler`` session that writes a Chrome trace
(open it in Perfetto or ``chrome://tracing``).

CUDA launches return before the card finishes, so every clock here stops
only after the card has finished the work it timed: :func:`block_until_ready`
synchronises the device of each CUDA tensor in a result tree.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List

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
    records the host alone."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        if torch.profiler.ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
