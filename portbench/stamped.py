"""The stamped slice of a ``--trace 1`` run: the port's own tracer, no profiler.

After the window and the traced slice, a second port adapter is built
inside ``utils.profiling.tracing`` of the port, so its graph holds the
port's stage marks (``graph.begin``, ``solve.*``, ``wb_loop.*``,
``graph.end``) and its calls record the port's host spans
(``graphs.load``, ``graphs.replay``, ``serving.reply``) and the capture's
time.  It runs the mix's ``trace`` count (requests: that many calls, each
with its readback; episodes: one call of that many steps) with no
``torch.profiler`` session, so both clocks run at the program's own pace,
and keeps the tracer's record (:class:`Stamped`) for the readers in
``metrics/``.

The harness hands a reader the :class:`~portbench.trace.Context` alone.  The
slice needs the run itself (device, cell, seed, sizes), which
:func:`of` finds on the caller's stack (the :class:`~portbench.runner.Run`
of ``runner.run``), and it keeps the record on the context, so that the
slice runs once for all the readers of a run.  It runs only on the card,
never for a stand-in, and not for a program without the tracer: each
reader then returns None.  The carry starts afresh from the run's keys
(the window's carry is not handed to the readers); requests are the
stream's first, episodes start from their own seeded starts.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from . import drivers, inputs

STAMPED_EPISODES = 1 << 41  # episode indices of the slice's starts, apart from the others'
PORT_SPANS = ("graphs.load", "graphs.replay", "serving.reply")


class Stamped:
    """A tracer record (``utils.profiling.Tracer.read``) and what the readers
    take from it.  Every time is None where a mark or span it needs is
    missing, never 0."""

    def __init__(self, rec: dict):
        self.rec = rec
        self.device = rec["clock"] == "device"
        self.col = {name: i for i, name in enumerate(rec["marks"])}
        self.rows = np.asarray(rec["rows"], dtype=np.int64).reshape(len(rec["rows"]),
                                                                    len(rec["marks"]))

    def stage_ns(self, a: str, b: str) -> Optional[np.ndarray]:
        """Per call (row) in which both marks were stamped, the device ns
        from mark ``a`` to mark ``b``; None on the host clock or without
        such a row."""
        if not self.device or a not in self.col or b not in self.col:
            return None
        x, y = self.rows[:, self.col[a]], self.rows[:, self.col[b]]
        both = (x > 0) & (y > 0)
        return (y - x)[both] if both.any() else None

    def stage_ms(self, a: str, b: str) -> Optional[float]:
        """The mean of :meth:`stage_ns` in ms."""
        d = self.stage_ns(a, b)
        return None if d is None else float(d.mean()) * 1e-6

    def span_ms(self, name: str) -> Optional[float]:
        """Mean host ms of the spans ``name``."""
        d = [end - start for _, n, start, end, _ in self.rec["spans"] if n == name]
        return float(np.mean(d)) * 1e-6 if d else None

    def capture_s(self) -> Optional[float]:
        return self.rec["capture_s"] if self.rec["captures"] else None

    def idle_gaps(self) -> Optional[np.ndarray]:
        """The card's idle intervals between calls, (n, 2) ns on the host
        clock: each call's ``graph.end`` to the next call's ``graph.begin``,
        mapped through the tracer's calibration; None without them."""
        from quadrotor_manipulator_mppi_tpu_torch.utils.profiling import to_host_ns

        if not self.device or "graph.begin" not in self.col or "graph.end" not in self.col:
            return None
        begin, end = self.rows[:, self.col["graph.begin"]], self.rows[:, self.col["graph.end"]]
        gaps = [(end[i], begin[i + 1]) for i in range(len(begin) - 1)
                if end[i] > 0 and begin[i + 1] > end[i]]
        if not gaps:
            return None
        return to_host_ns(np.asarray(gaps, dtype=np.float64).ravel(),
                          self.rec["calibrations"]).reshape(-1, 2)

    def idle_in_spans_ns(self, names) -> Optional[float]:
        """The idle time between calls in which one of the host spans
        ``names`` was open, ns in all."""
        gaps = self.idle_gaps()
        if gaps is None:
            return None
        spans = [(s, e) for _, n, s, e, _ in self.rec["spans"] if n in names]
        return overlap_ns(gaps, spans) if spans else None

    def idle_in_port_share(self) -> Optional[float]:
        """Of the idle time between calls (:meth:`idle_gaps`), the share in %
        in which one of the port's host spans (:data:`PORT_SPANS`) was
        open."""
        gaps, covered = self.idle_gaps(), self.idle_in_spans_ns(PORT_SPANS)
        if covered is None:
            return None
        return 100.0 * covered / float((gaps[:, 1] - gaps[:, 0]).sum())

    def resolution_ns(self) -> Optional[int]:
        """The smallest nonzero difference between two stamps of one row."""
        if not self.device or not self.rows.size:
            return None
        rows = np.sort(self.rows, axis=1)
        d = np.diff(rows, axis=1)
        d = d[(d > 0) & (rows[:, :-1] > 0)]
        return int(d.min()) if d.size else None


def overlap_ns(gaps, spans) -> float:
    """The time of the intervals ``gaps`` covered by the union of ``spans``."""
    from .trace import merged

    union = merged((float(s), float(e)) for s, e in spans)
    total = 0.0
    for a, b in gaps:
        for s, e in union:
            total += max(0.0, min(b, e) - max(a, s))
    return total


def _tracing():
    """The port's ``tracing``, or None for a program without the tracer."""
    from quadrotor_manipulator_mppi_tpu_torch.utils import profiling

    return getattr(profiling, "tracing", None)


def _find_run():
    """The :class:`~portbench.runner.Run` in the nearest caller's locals."""
    from .runner import Run

    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, Run):
                return v
        f = f.f_back
    return None


def of(ctx) -> Optional[Stamped]:
    """The stamped slice of the run reading ``ctx`` (run at the first call,
    kept on ``ctx``), or None where it does not run."""
    if not hasattr(ctx, "stamped"):
        r = _find_run()
        ok = r is not None and r.dev.type == "cuda" and not r.args.stand_in
        ctx.stamped = run_slice(r) if ok and _tracing() is not None else None
    return ctx.stamped


def run_slice(r) -> Stamped:
    """Run the stamped slice of the run ``r`` (any device: on the CPU the
    marks are on the host clock) and return its record."""
    import gc

    import torch

    tracing = _tracing()
    with tracing(r.dev) as tracer:
        if r.cell.driver == "episode":
            _episodes(r, tracer)
        else:
            _requests(r, tracer)
        rec = tracer.read()
    gc.collect()
    if r.dev.type == "cuda":
        torch.cuda.empty_cache()
    st = Stamped(rec)
    _log(st)
    return st


def _requests(r, tracer) -> None:
    import torch

    mix, dev, B = r.mix, r.dev, r.shape["B"]
    kind = "packed" if r.cell.driver == "packed" else "flat"
    stream = inputs.VehicleStream(r.args.seed, r.cell.config["task"], mix)
    ad = drivers.port_adapter(r.cell.driver, r.cell.config, dev, r.shape)
    carry = ad.init(inputs.request_keys(r.args.seed, B))
    n = int(mix["trace"]["calls"])
    host = torch.from_numpy(np.concatenate([stream.block(b, kind)
                                            for b in range(-(-(n + 2) // inputs.BLOCK))]))
    if dev.type == "cuda":
        host = host.pin_memory()
    for i in range(n + 2):
        if i == 2:  # after the capture and one more call
            tracer.reset()
        x = host[i].to(dev, non_blocking=True)
        reply, carry = ad.call(carry, x)
        reply.cpu()
    del ad, carry


def _episodes(r, tracer) -> None:
    mix, dev = r.mix, r.dev
    ad = drivers.port_adapter("episode", r.cell.config, dev, r.shape, int(mix["trace"]["steps"]))
    task = r.cell.config["task"]
    for e in range(2):  # an episode with the capture, then the stamped one
        if e == 1:
            tracer.reset()
        args = ad.start(inputs.episode_start(r.args.seed, STAMPED_EPISODES + e, task, mix))
        ad.call(args)
    del ad


def _log(st: Stamped) -> None:
    """One line on standard error: the record's size, the per-call device
    span, the idle time between calls by the port's spans, the clock's
    error and the smallest step between two stamps of a call."""
    from .core import log

    cal = st.rec["calibrations"]
    span = st.stage_ns("graph.begin", "graph.end")
    gaps = st.idle_gaps()
    idle = "no idle gaps"
    if gaps is not None:
        n = len(gaps)
        parts = [f"{name} {(st.idle_in_spans_ns((name,)) or 0.0) / n * 1e-6:.5f}"
                 for name in PORT_SPANS]
        idle = (f"idle between calls {(gaps[:, 1] - gaps[:, 0]).mean() * 1e-6:.5f} ms per call, "
                f"in port spans {(st.idle_in_spans_ns(PORT_SPANS) or 0.0) / n * 1e-6:.5f} ms ("
                + ", ".join(parts) + ")")
    log(f"stamped slice: {len(st.rows)} rows of {len(st.rec['marks'])} marks "
        f"({', '.join(st.rec['marks'])}), {len(st.rec['spans'])} host spans, "
        f"{st.rec['captures']} capture(s) in {st.rec['capture_s']:.3f} s; per-row device span "
        f"{'not measured' if span is None else f'{span.mean() * 1e-6:.5f} ms'}; {idle}; "
        f"clock error {', '.join(str(c['error_ns']) for c in cal)} ns; smallest stamp step "
        f"{st.resolution_ns()} ns")
