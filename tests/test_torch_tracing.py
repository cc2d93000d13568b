"""The port's tracer (``utils/profiling``): stage marks, host spans, one clock.

CPU cases: with no tracer installed a serving solve and a whole-body
episode record nothing and open no profiler range; with one installed the
marks come out once per call or step in the documented order, the stages of
a step add up to its span, spans nest with their parents, the ring keeps
its newest rows, marks open same-named ranges under a profiler, and the
outputs are bit-equal with tracing on and off.  ``cuda`` cases (each
decides in its body whether a card exists): a stamped graph bit-equal to
the unstamped one, exactly one more device op per mark and replay, a graph
captured after a tracer was removed holding no mark, the stamped episode's
rows on the card with the clock's calibration, and no host sync in the
serving call or the episode call.  This file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m cuda
"""

import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.solver import serving
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb
from quadrotor_manipulator_mppi_tpu_torch.utils import profiling

SOLVE = ["solve.cost", "solve.update", "solve.tail"]
STEP = ["wb_loop.solve"] + SOLVE + ["wb_loop.servo", "wb_loop.arm_dynamics", "wb_loop.carrot",
                                    "wb_loop.tick", "wb_loop.logs"]
VOCABULARY = ("graph.", "solve.", "wb_loop.", "graphs.", "serving.")
LOOP = dict(arm_coeffs_per_control=True, plant_kernel=True)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _params(k=64, h=8):
    return wb.position_mode_params(n_samples=k, n_horizon=h)


def _serve(dev, n, **kw):
    """``n`` packed serving solves from seed 2: (replies, final warm start)."""
    pstep, pinit = serving.make_packed_step(_params(), device=dev, low_k_guard="off", **kw)
    vecs = serving.pack_obs(wb.default_obs(device=dev))
    carry, outs = pinit(2), []
    for _ in range(n):
        out, carry = pstep(carry, *vecs)
        outs.append(out)
    return outs, carry.u_prev.clone()


def _episode(dev, n_steps, n_scenarios=None, **kw):
    """``run`` of a position-mode serving-configuration episode, and its start."""
    params = _params()
    run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**LOOP),
                                      n_control_steps=n_steps, device=dev, low_k_guard="off",
                                      n_scenarios=n_scenarios, **kw)
    if n_scenarios:
        return run, wbl.fleet_starts(params, n_scenarios, seed=1, device=dev)
    _, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off")
    obs = wb.default_obs(device=dev)
    return run, (wbl.init_plant(params.model.vehicle, device=dev), init(1), obs.ee_target,
                 obs.base_target)


def _range_names(prof) -> list:
    return [e.name for e in prof.events() if e.name.startswith(VOCABULARY)]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_no_tracer_records_nothing_and_opens_no_range():
    assert profiling.current() is None
    assert profiling.span("graphs.replay") is profiling.span("serving.reply")  # shared no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve("cpu", 2)
        run, start = _episode("cpu", 3)
        run(*start)
    assert _range_names(prof) == []
    assert profiling.current() is None


def test_serving_marks_once_per_call_in_order():
    with profiling.tracing("cpu") as tracer:
        _serve("cpu", 3)
        rec = tracer.read()
    assert rec["marks"] == SOLVE and rec["clock"] == "host" and rec["rows"].shape == (3, 3)
    assert (np.diff(rec["rows"], axis=1) > 0).all() and (np.diff(rec["rows"][:, 0]) > 0).all()
    assert profiling.current() is None


def test_episode_marks_once_per_step_in_order():
    run, start = _episode("cpu", 3)
    with profiling.tracing("cpu") as tracer:
        run(*start)
        rec = tracer.read()
    assert rec["marks"] == STEP and rec["rows"].shape == (3, len(STEP))
    assert (np.diff(rec["rows"], axis=1) > 0).all()
    assert (rec["rows"][1:, 0] > rec["rows"][:-1, -1]).all()  # one row per step, in turn


def test_stages_of_a_step_sum_to_its_span():
    """Each one-step call between graph.begin and graph.end (as a capture
    holds them): every mark once, in order, and the stages from one mark to
    the next add up exactly to graph.begin -> graph.end."""
    run, start = _episode("cpu", 1)
    with profiling.tracing("cpu") as tracer:
        for _ in range(3):
            profiling.mark("graph.begin")
            start = run(*start)[0]
            profiling.mark("graph.end")
        rec = tracer.read()
    assert rec["marks"] == ["graph.begin"] + STEP + ["graph.end"]
    rows = rec["rows"]
    stages = np.diff(rows, axis=1)
    assert rows.shape == (3, len(STEP) + 2) and (stages > 0).all()
    assert (stages.sum(axis=1) == rows[:, -1] - rows[:, 0]).all()


def test_spans_nest_with_their_parents():
    with profiling.tracing("cpu") as tracer:
        with profiling.span("outer"):
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    pass
            with profiling.span("sibling"):
                pass
            other = threading.Thread(target=lambda: profiling.span("thread").__enter__()
                                     .__exit__(None, None, None))
            other.start()
            other.join(timeout=10)
        assert not other.is_alive()
        spans = {s[1]: s for s in tracer.read()["spans"]}
    ids = {name: s[0] for name, s in spans.items()}
    parent = {name: s[4] for name, s in spans.items()}
    assert parent == {"outer": None, "inner": ids["outer"], "leaf": ids["inner"],
                      "sibling": ids["outer"], "thread": None}
    for name, (_, _, start, end, _) in spans.items():
        assert start <= end
        if parent[name] is not None:
            p = next(s for s in spans.values() if s[0] == parent[name])
            assert p[2] <= start and end <= p[3]
    assert tracer.calls == {n: 1 for n in spans}


def test_ring_keeps_the_newest_rows_and_reset_clears(monkeypatch):
    monkeypatch.setattr(profiling, "RING_ROWS", 4)
    with profiling.tracing("cpu") as tracer:
        for _ in range(6):
            profiling.mark("a")
            profiling.mark("b")
        rows = tracer.read()["rows"]
        assert rows.shape == (4, 2) and (np.diff(rows[:, 0]) > 0).all()
        tracer.reset()
        assert tracer.read()["rows"].shape == (0, 2)
        profiling.mark("b")
        assert tracer.read()["rows"][:, 0].tolist() == [0]  # "a" not stamped in this row


def test_tracing_nests_and_counts_mark_names():
    with profiling.tracing("cpu") as outer:
        with profiling.tracing("cpu") as inner:
            assert profiling.current() is inner
            for i in range(profiling.MAX_MARKS):
                profiling.mark(f"m.{i}")
            with pytest.raises(ValueError, match="at most"):
                profiling.mark("one.more")
        assert profiling.current() is outer and outer.read()["marks"] == []
    assert profiling.current() is None


def test_clock_calibration_on_the_host():
    with profiling.tracing("cpu") as tracer:
        rec = tracer.read()
    assert len(rec["calibrations"]) == 2
    assert all(c["offset_ns"] == 0 and c["error_ns"] == 0 for c in rec["calibrations"])
    # a device clock 1000 ns ahead at the first calibration, 1100 ns at the second
    cals = [{"host_ns": 0, "offset_ns": 1000, "error_ns": 5},
            {"host_ns": 10_000, "offset_ns": 1100, "error_ns": 5}]
    got = profiling.to_host_ns([1000, 6050, 11_100, 20_000], cals)
    assert got.tolist() == [0.0, 5000.0, 10_000.0, 18_900.0]


def test_marks_open_named_ranges_under_a_profiler():
    """``profiling.trace`` installs a tracer: the eager episode keeps its
    wb_loop.* ranges, the solve's stages nested in wb_loop.solve."""
    run, start = _episode("cpu", 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing("cpu") as tracer:
            run(*start)
            tracer.close_ranges()
    ranges = {}
    for e in prof.events():
        if e.name.startswith(VOCABULARY):
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert set(ranges) == set(STEP) and all(len(v) == 2 for v in ranges.values())
    for (s0, e0), (s1, e1) in zip(ranges["wb_loop.solve"], ranges["solve.tail"]):
        assert s0 <= s1 and e1 <= e0


def test_trace_installs_a_tracer(tmp_path):
    seen = []
    with profiling.trace(str(tmp_path), device="cpu"):
        seen.append(profiling.current())
    assert isinstance(seen[0], profiling.Tracer) and profiling.current() is None


def test_outputs_bit_equal_with_tracing_on_and_off():
    off = _serve("cpu", 3)
    with profiling.tracing("cpu"):
        on = _serve("cpu", 3)
    assert all(torch.equal(a, b) for a, b in zip(off[0], on[0])) and torch.equal(off[1], on[1])
    run, start = _episode("cpu", 3)
    (_, logs_off) = run(*start)
    with profiling.tracing("cpu"):
        (_, logs_on) = run(*start)
    for name, a, b in zip(logs_off._fields, logs_off, logs_on):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# cuda
# ---------------------------------------------------------------------------

def _device_ops(fn, n) -> int:
    """Device operations (kernels, copies, sets) the profiler sees in ``n``
    calls of ``fn``, annotations left out."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
               and not e.name().startswith(VOCABULARY + ("ProfilerStep",)))


def _serving_call(dev):
    pstep, pinit = serving.make_packed_step(_params(), device=dev, low_k_guard="off")
    vecs = serving.pack_obs(wb.default_obs(device=dev))
    state = {"carry": pinit(0)}

    def call():
        out, state["carry"] = pstep(state["carry"], *vecs)
        return out

    call()  # the capture
    return call


@pytest.mark.cuda
def test_stamped_graph_bit_equal_to_unstamped():
    dev = _card()
    off = _serve(dev, 6)
    with profiling.tracing(dev) as tracer:
        on = _serve(dev, 6)
        rec = tracer.read()
    assert all(torch.equal(a, b) for a, b in zip(off[0], on[0])) and torch.equal(off[1], on[1])
    # the capture's two warm-up calls and 6 replays, each a row
    assert rec["marks"] == ["graph.begin"] + SOLVE + ["graph.end"] and rec["clock"] == "device"
    assert rec["rows"].shape == (8, 5) and (np.diff(rec["rows"], axis=1) >= 0).all()
    assert (rec["rows"] > 0).all() and rec["captures"] == 1 and rec["capture_s"] > 0
    assert rec["calls"]["graphs.replay"] == 6 and rec["calls"]["serving.reply"] == 6
    fleet = []
    for tracing in (False, True):
        with profiling.tracing(dev) if tracing else contextlib.nullcontext():
            run, start = _episode(dev, 5, n_scenarios=3)
            fleet.append(run(*start))
    for name, a, b in zip(fleet[0][1]._fields, fleet[0][1], fleet[1][1]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_stamped_graph_adds_one_device_op_per_mark():
    dev = _card()
    n = 10
    before = _device_ops(_serving_call(dev), n)
    with profiling.tracing(dev):
        stamped = _serving_call(dev)
    assert _device_ops(stamped, n) - before == 5 * n  # graph.begin, solve.*, graph.end


@pytest.mark.cuda
def test_a_graph_captured_after_the_tracer_holds_no_mark():
    dev = _card()
    first = _device_ops(_serving_call(dev), 4)
    with profiling.tracing(dev):
        pass
    assert _device_ops(_serving_call(dev), 4) == first


@pytest.mark.cuda
def test_stamped_episode_rows_and_clock_on_the_card():
    dev = _card()
    with profiling.tracing(dev) as tracer:
        run, start = _episode(dev, 4, n_scenarios=3)
        run(*start)
        tracer.reset()
        run(*start)
        rec = tracer.read()
    assert rec["marks"] == ["graph.begin"] + STEP + ["graph.end"]
    rows = rec["rows"]
    assert rows.shape == (4, len(STEP) + 2) and (rows > 0).all()
    stages = np.diff(rows, axis=1)
    assert (stages >= 0).all() and (stages.sum(axis=1) == rows[:, -1] - rows[:, 0]).all()
    assert rec["calls"]["graphs.replay"] == 8
    cal = rec["calibrations"]
    assert len(cal) == 2 and all(0 < c["error_ns"] < 1_000_000 for c in cal)
    host = profiling.to_host_ns(rows[:, 0], cal)
    replays = sorted(s[2] for s in rec["spans"] if s[1] == "graphs.replay")
    # each step's device start follows its replay's launch on the host clock
    assert (host + 2 * max(c["error_ns"] for c in cal) >= np.asarray(replays[-4:])).all()


@pytest.mark.cuda
def test_no_host_sync_in_the_serving_call_or_the_episode_call():
    dev = _card()
    call = _serving_call(dev)
    run, start = _episode(dev, 5)
    run(*start)  # the capture
    start = (start[0], wbl.device_counters(start[1], dev)) + start[2:]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
        run(*start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
