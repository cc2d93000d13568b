"""The measured window, the traced slice and the check of one run."""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext

import numpy as np
import torch

from . import check, drivers, inputs
from . import trace as tr
from .reference import solve as ref_solve

_SAMPLE = 0xC4EC
TRACE_EPISODES = 1 << 40  # episode indices of the traced slice's starts, apart from the window's


def _span(on: bool, name: str):
    if not on:
        return nullcontext()
    from torch.profiler import record_function

    return record_function(tr.SPAN_PREFIX + name)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    return profile(activities=acts)


def _slice(dev, go, warm) -> dict:
    """The traced slice after the window: ``warm()`` under a first session
    (a process's first is slow), then ``go()`` under ``torch.profiler`` with
    the host's and the device's activity, inside the span ``traced``, from
    an idle card to an idle card.  Returns :func:`trace.collect`'s record."""
    with _profile(dev):
        warm()
        _sync(dev)
    with _profile(dev) as prof:
        with _span(True, "traced"):
            go()
            _sync(dev)
    return tr.collect(prof)


class CallSpans:
    """The device time of the window's calls, for the idle share: a pair of
    CUDA events around each call (recorded before its first op and after its
    last op is enqueued, on the current stream), read once the call has
    synchronised.  The card counts as busy from the one to the other, gaps
    between a graph's kernels included; the time between calls, when the
    card waits for the host, is idle.  ``busy_s`` stays None on the CPU."""

    def __init__(self, dev, on: bool = True):
        self.on = on and dev.type == "cuda"
        self.busy_s = 0.0 if self.on else None
        if self.on:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.on:
            self.a.record()

    def stop(self) -> None:
        if self.on:
            self.b.record()

    def read(self) -> None:
        if self.on:
            self.b.synchronize()
            self.busy_s += self.a.elapsed_time(self.b) * 1e-3


NO_SPANS = CallSpans(torch.device("cpu"), on=False)


def _sample_calls(seed: int, first: int, every: int, limit: int = 10**7) -> set:
    """The window's sampled calls: the first, then gaps drawn from the seed
    (mean ``every``)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, _SAMPLE]))
    out, i = {first}, first
    while i < limit:
        i += int(rng.integers(1, 2 * every))
        out.add(i)
        if len(out) > 100000:
            break
    return out


def window_metrics(solves: int, window_s: float, setup_s: float, latencies=None) -> dict:
    """The end-to-end metrics of a window: every solve completed in it over
    its whole length, and the 95th percentile of every request's latency."""
    from .core import percentile

    out = {"setup_s": setup_s, "solves_per_s": solves / window_s}
    if latencies:
        out["latency_p95_ms"] = percentile(latencies, 95) * 1e3
    return out


class Run:
    """State of one run: the cell, its sizes, timings and records."""

    def __init__(self, cell, args, dev, t_start, ov):
        self.cell, self.args, self.dev, self.t_start = cell, args, dev, t_start
        self.shape = dict(cell.shape)
        self.shape.update({k: int(ov[k]) for k in ("K", "H", "B") if k in ov})
        self.mix = dict(cell.mix, vehicles=self.shape["B"])
        self.mix.update({k: ov[k] for k in ("episode_steps", "warmup_calls", "trace") if k in ov})
        self.check_mix = dict(self.mix["check"], **ov.get("check", {}))
        self.rng = np.random.default_rng(np.random.SeedSequence([args.seed, _SAMPLE, 1]))
        self.attempted = self.failed = 0

    def adapter(self, n_steps=None):
        c, a = self.cell, self.args
        if a.stand_in:
            return drivers.stand_in_adapter(a.stand_in, c.driver, c.config, self.dev, self.shape,
                                            int(self.check_mix.get("steps", 3)), n_steps)
        return drivers.port_adapter(c.driver, c.config, self.dev, self.shape, n_steps)

    def vehicles(self) -> np.ndarray:
        n = self.shape["B"]
        k = min(int(self.check_mix["sampled_vehicles"]), n)
        return np.sort(self.rng.choice(n, size=k, replace=False))

    def device(self) -> dict:
        if self.dev.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.dev), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(self.dev))}


# ------------------------------------------------------------------ requests


def run_requests(r: Run):
    mix, dev, B = r.mix, r.dev, r.shape["B"]
    packed = r.cell.driver == "packed"
    stream = inputs.VehicleStream(r.args.seed, r.cell.config["task"], mix)
    keys = inputs.request_keys(r.args.seed, B)
    t_built = time.perf_counter()
    ad = r.adapter()
    state = {"carry": ad.init(keys)}
    t_built = (t_built - r.t_start, time.perf_counter() - r.t_start)
    warm = int(mix["warmup_calls"])
    sampled = _sample_calls(r.args.seed, warm, int(r.check_mix["every"]))
    sampled.add(0)
    records = []

    kind, staged = ("packed" if packed else "flat"), {}

    def host_block(b: int) -> torch.Tensor:
        """Requests of block ``b`` in host memory (pinned for the card), made
        once per block of ``inputs.BLOCK`` requests."""
        if b not in staged:
            staged.pop(b - 2, None)
            t = torch.from_numpy(stream.block(b, kind))
            staged[b] = t.pin_memory() if dev.type == "cuda" else t
        return staged[b]

    def one(i: int, traced: bool = False, spans: CallSpans = NO_SPANS):
        with _span(traced, "inputs"):
            x_host = host_block(i // inputs.BLOCK)[i % inputs.BLOCK]
        before = ad.snapshot(state["carry"]) if i in sampled else None
        t0 = time.perf_counter()
        with _span(traced, "enqueue"):
            spans.start()
            x = x_host.to(dev, non_blocking=True)
            reply, state["carry"] = ad.call(state["carry"], x)
            spans.stop()
        t_enq = time.perf_counter()
        with _span(traced, "readback"):
            out = reply.cpu().numpy()
        t1 = time.perf_counter()
        spans.read()
        ok = bool(np.isfinite(out).all())
        if before is not None:
            u_after = ad.snapshot(state["carry"])[0].double().cpu().numpy()
            u_before, step = before[0].double().cpu().numpy(), int(before[1].reshape(-1)[0])
            for b in r.vehicles():
                records.append({"key": keys[b], "step": step, "x": x_host[b].numpy().copy(),
                                "u_before": None if i == 0 else u_before[b],
                                "reply": out[b], "u_after": u_after[b]})
        return t1 - t0, t_enq - t0, ok

    for i in range(warm):
        one(i)
        if i == 0:
            t_first = time.perf_counter() - r.t_start
    _sync(dev)
    lat, enq, i = [], [], warm
    spans = CallSpans(dev, on=bool(r.args.trace))
    t_w0 = time.perf_counter()
    setup_s = t_w0 - r.t_start
    while time.perf_counter() - t_w0 < r.args.seconds:
        dt, de, ok = one(i, spans=spans)
        lat.append(dt)
        enq.append(de)
        r.attempted += 1
        r.failed += not ok
        i += 1
    t_w1 = time.perf_counter()
    e2e = window_metrics(len(lat) * B, t_w1 - t_w0, setup_s, lat)
    per_s = np.bincount((np.cumsum(lat) // 1.0).astype(int)) if lat else np.zeros(1)
    log_line = (f"window: {len(lat)} calls x {B} vehicle(s) in {t_w1 - t_w0:.3f} s; "
                f"set-up {setup_s:.3f} s (imports {t_built[0]:.2f}, the port built "
                f"{t_built[1]:.2f}, first call with its capture {t_first:.2f}); calls in "
                "each second of request time: " + " ".join(str(int(c)) for c in per_s))

    layer = None
    if r.args.trace:
        sampled.difference_update(range(i, i + 10**6))
        n_tr = int(mix["trace"]["calls"])
        nxt = iter(range(i, i + 10**6))

        def go():
            for _ in range(n_tr):
                one(next(nxt), traced=True)

        traced = _slice(dev, go, lambda: [one(next(nxt)) for _ in range(2)])
        layer = (traced, n_tr, enq, (spans.busy_s, t_w1 - t_w0))
    return e2e, layer, records, log_line, ad


def numbers_requests(r: Run, records: list) -> dict:
    ref = ref_solve.Reference(r.cell.config, r.dev, torch.float64, False, r.shape["K"],
                              r.shape["H"])
    return check.request_numbers(ref, r.cell.driver, records)


# ------------------------------------------------------------------ episodes


def _subset(start: dict, idx) -> dict:
    return {k: ([v[i] for i in idx] if k == "keys" else np.asarray(v)[idx])
            for k, v in start.items()}


def run_episodes(r: Run):
    mix, dev, B = r.mix, r.dev, r.shape["B"]
    steps = int(r.check_mix["steps"])
    calls = int(mix.get("calls_per_episode", 1))
    n_steps = int(mix["episode_steps"])
    if n_steps % calls or n_steps // calls < steps:
        raise SystemExit(f"{n_steps} steps do not split into {calls} calls of {steps} or more")
    task = r.cell.config["task"]
    ad = r.adapter(n_steps // calls)
    t_built = time.perf_counter() - r.t_start
    trace_ad = r.adapter(int(mix["trace"]["steps"])) if r.args.trace else None
    records = []

    def one(e: int, adapter, n_calls: int, traced: bool = False, check: bool = False,
            spans: CallSpans = NO_SPANS):
        """Episode ``e``: its seeded start, then ``n_calls`` calls, each from
        the carry the previous one returned; with ``check``, the sampled
        vehicles' rows of each call for the check."""
        st = inputs.episode_start(r.args.seed, e, task, mix)
        idx = r.vehicles() if check else None
        with _span(traced, "start"):
            args = adapter.start(st)
        ok = True
        for c in range(n_calls):
            rows = adapter.rows(args, idx) if check and c else None
            with _span(traced, "episode"):
                spans.start()
                args, logs = adapter.call(args)
                spans.stop()
                spans.read()
            ok = ok and all(np.isfinite(v).all() for v in logs.values())
            if check:
                records.append({"start": _subset(st, idx), "carry": rows,
                                "step0": c * (n_steps // calls),
                                "logs": {f: v[idx, :steps] for f, v in logs.items()}})
        return ok

    one(0, ad, calls, check=True)  # the capture, and the first episode of the run
    t_first = time.perf_counter() - r.t_start
    trace_eps = iter(range(TRACE_EPISODES, TRACE_EPISODES + 5))
    if trace_ad is not None:
        one(next(trace_eps), trace_ad, 1)
    _sync(dev)
    n_eps, e = 0, 1
    spans = CallSpans(dev, on=bool(r.args.trace))
    t_w0 = time.perf_counter()
    setup_s = t_w0 - r.t_start
    while time.perf_counter() - t_w0 < r.args.seconds:
        ok = one(e, ad, calls, check=True, spans=spans)
        r.attempted += 1
        r.failed += not ok
        n_eps += 1
        e += 1
    t_w1 = time.perf_counter()
    e2e = window_metrics(n_eps * n_steps * B, t_w1 - t_w0, setup_s)
    log_line = (f"window: {n_eps} episodes x {n_steps} steps ({calls} calls) x {B} vehicle(s) "
                f"in {t_w1 - t_w0:.3f} s; set-up {setup_s:.3f} s (imports and build "
                f"{t_built:.2f}, first episode with its capture {t_first:.2f})")
    layer = None
    if trace_ad is not None:
        traced = _slice(dev, lambda: one(next(trace_eps), trace_ad, 1, traced=True),
                        lambda: one(next(trace_eps), trace_ad, 1))
        layer = (traced, int(mix["trace"]["steps"]), [], (spans.busy_s, t_w1 - t_w0))
    return e2e, layer, records, log_line, (ad, trace_ad)


def numbers_episodes(r: Run, records: list) -> dict:
    ref = ref_solve.Reference(r.cell.config, r.dev, torch.float64, False, r.shape["K"],
                              r.shape["H"])
    return check.episode_numbers(ref, r.shape["loop"], int(r.check_mix["steps"]), records)


# ---------------------------------------------------------------------- run


def run(cell, args, dev, t_start, ov):
    from .core import log

    r = Run(cell, args, dev, t_start, ov)
    requests = cell.driver in ("packed", "batched")
    e2e, layer, records, log_line, held = (run_requests if requests else run_episodes)(r)
    log(log_line)
    device = r.device()
    result = {"correct": False, "attempted": r.attempted, "failed": r.failed, "metrics": {},
              "device": device}
    if args.trace:
        traced, units, enq, window = layer
        ctx = tr.Context(traced, units, r.shape, enq, window, device["kind"])
        device["busy_s"] = ctx.busy_ns() * 1e-9
        device["window_s"] = (ctx.slice_ns[1] - ctx.slice_ns[0]) * 1e-9
        for m in cell.metrics("per_layer"):
            v = tr.load_metric(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.top_ops(ctx.ops),
                               "idle_gaps": tr.idle_gaps_by_span(traced)}
    else:
        # "<quantity>.<cells>" is the quantity under a bound of those cells' own
        for m in cell.metrics("end_to_end"):
            quantity = m["name"].split(".", 1)[0]
            if quantity in e2e:
                result["metrics"][m["name"]] = {"value": e2e[quantity], "unit": m["unit"]}
    del held, layer
    gc.collect()
    check.free_device()
    numbers = (numbers_requests if requests else numbers_episodes)(r, records)
    ok, shown = check.judge(numbers, cell.limits)
    result["correct"] = bool(ok and r.failed == 0 and r.attempted > 0 and records)
    return result, shown
