"""The stamped slice's readers (``stamped.py``, the readers it feeds): each on
a synthetic tracer record, None for a missing mark or span, the idle share
put down to the port's spans on a hand-built timeline, and the slice run on
the CPU at tiny sizes."""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import core, runner, stamped  # noqa: E402
from portbench import trace as tr  # noqa: E402

from test_portbench_harness import TINY  # noqa: E402

SERVE = ["graph.begin", "solve.cost", "solve.update", "solve.tail", "graph.end"]
STEP = ["graph.begin", "wb_loop.solve", "solve.cost", "solve.update", "solve.tail",
        "wb_loop.servo", "wb_loop.arm_dynamics", "wb_loop.carrot", "wb_loop.tick",
        "wb_loop.logs", "graph.end"]
CAL = [{"host_ns": 0, "offset_ns": 0, "error_ns": 3000},
       {"host_ns": 10**9, "offset_ns": 0, "error_ns": 3000}]


def record(marks, rows, spans=(), captures=1, capture_s=2.5, clock="device", cal=CAL):
    return {"marks": list(marks), "rows": np.asarray(rows, dtype=np.int64), "clock": clock,
            "spans": list(spans), "calls": {}, "captures": captures, "capture_s": capture_s,
            "calibrations": cal}


def ctx_of(rec):
    c = tr.Context({"ops": [], "spans": []}, 1, {"B": 1, "K": 64, "H": 10, "A": 11}, [],
                   (None, 1.0), "NVIDIA H100 80GB HBM3")
    c.stamped = None if rec is None else stamped.Stamped(rec)
    return c


def read(name, rec):
    return tr.load_metric(name).read(ctx_of(rec))


def serve_rows():
    # two calls, 10 us apart in each stage; begin at 1000 and 3000 us
    return [[1_000_000 + 10_000 * j for j in range(5)],
            [3_000_000 + 10_000 * j * 2 for j in range(5)]]


@pytest.mark.parametrize("name,want_ms", [("solver.prologue_ms", 0.015),
                                          ("solver.tail_ms", 0.015)])
def test_solver_stages(name, want_ms):
    assert read(name, record(SERVE, serve_rows())) == pytest.approx(want_ms)
    marks = [m for m in SERVE if m != ("solve.cost" if "prologue" in name else "graph.end")]
    assert read(name, record(marks, [r[:4] for r in serve_rows()])) is None
    assert read(name, record(SERVE, serve_rows(), clock="host")) is None
    assert read(name, None) is None


@pytest.mark.parametrize("i,name", list(enumerate(["episode.solve_ms", "episode.servo_ms",
                                                   "episode.arm_ms", "episode.carrot_ms",
                                                   "episode.plant_ms", "episode.logs_ms"])))
def test_episode_stages(i, name):
    # stage j of a step lasts j + 1 us; the six metrics read from wb_loop.solve on
    steps = [np.concatenate([[0], np.cumsum(np.arange(1, 11))]) * 1000 + 10**7 * s
             for s in (1, 2, 3)]
    rec = record(STEP, steps)
    starts = {"episode.solve_ms": 1, "episode.servo_ms": 5, "episode.arm_ms": 6,
              "episode.carrot_ms": 7, "episode.plant_ms": 8, "episode.logs_ms": 9}
    a = starts[name]
    b = [1, 5, 6, 7, 8, 9, 10][i + 1]
    assert read(name, rec) == pytest.approx((steps[0][b] - steps[0][a]) * 1e-6)
    # a mark missing in every row: None, not 0
    rows = np.asarray(steps)
    rows[:, a] = 0
    assert read(name, record(STEP, rows)) is None


def test_episode_stages_sum_to_the_step():
    steps = [np.concatenate([[0], np.cumsum(np.arange(1, 11))]) * 1000 + 10**7 * s
             for s in (1, 2)]
    rec = record(STEP, steps)
    names = ["episode.solve_ms", "episode.servo_ms", "episode.arm_ms", "episode.carrot_ms",
             "episode.plant_ms", "episode.logs_ms"]
    total = sum(read(n, rec) for n in names)
    st = stamped.Stamped(rec)
    assert total == pytest.approx(st.stage_ms("wb_loop.solve", "graph.end"))
    assert st.stage_ms("graph.begin", "graph.end") == pytest.approx(total + 1e-3)
    assert st.resolution_ns() == 1000


def test_host_spans_and_capture():
    spans = [(1, "graphs.load", 0, 4000, None), (2, "graphs.replay", 5000, 25_000, None),
             (3, "graphs.load", 100_000, 106_000, None),
             (4, "graphs.replay", 107_000, 117_000, None)]
    rec = record(SERVE, serve_rows(), spans)
    assert read("graphs.load_ms", rec) == pytest.approx(0.005)
    assert read("graphs.replay_ms", rec) == pytest.approx(0.015)
    assert read("graphs.capture_s", rec) == pytest.approx(2.5)
    bare = record(SERVE, serve_rows(), [], captures=0, capture_s=0.0)
    assert read("graphs.load_ms", bare) is None and read("graphs.replay_ms", bare) is None
    assert read("graphs.capture_s", bare) is None


def test_idle_in_port_share_on_a_known_timeline(capsys):
    """Three calls; the device idles 1000-2000 and 3100-4100 us (graph.end
    to the next graph.begin).  Port spans cover 1500-1800 (load) and
    3000-3600 (replay, of which 3100-3600 lies in a gap): 800 of 2000 us."""
    us = 1000
    rows = [[0, 0, 0, 0, 1000 * us], [2000 * us, 0, 0, 0, 3100 * us],
            [4100 * us, 0, 0, 0, 5000 * us]]
    spans = [(1, "graphs.load", 1500 * us, 1800 * us, None),
             (2, "graphs.replay", 3000 * us, 3600 * us, None),
             (3, "caller", 1000 * us, 2000 * us, None)]
    assert read("device.idle_in_port_share", record(SERVE, rows, spans)) == pytest.approx(40.0)
    # the device clock 500 us ahead of the host's: the gaps move back by 500 us
    ahead = [{"host_ns": 0, "offset_ns": 500 * us, "error_ns": 1}] * 2
    shifted = [[x + 500 * us if x else 0 for x in r] for r in rows]
    assert read("device.idle_in_port_share", record(SERVE, shifted, spans, cal=ahead)) \
        == pytest.approx(40.0)
    stamped._log(stamped.Stamped(record(SERVE, rows, spans)))
    line = capsys.readouterr().err
    assert "idle between calls 1.00000 ms per call, in port spans 0.40000 ms" in line
    assert "graphs.load 0.15000, graphs.replay 0.25000, serving.reply 0.00000" in line
    assert read("device.idle_in_port_share", record(SERVE, rows, spans[2:])) is None
    assert read("device.idle_in_port_share", record(SERVE[1:], [r[1:] for r in rows],
                                                    spans)) is None


def test_no_slice_without_a_run_or_off_the_card():
    c = tr.Context({"ops": [], "spans": []}, 1, {"B": 1}, [], (None, 1.0), "cpu")
    assert stamped.of(c) is None and c.stamped is None  # no run on the stack
    assert tr.load_metric("solver.tail_ms").read(c) is None


@pytest.mark.parametrize("cell,extra", [("wb_att_k4096.serve_b1", {"B": 1}),
                                        ("wb_att_k4096.batch_b256", {"B": 2}),
                                        ("wb_pos_k512.fleet_b256",
                                         {"B": 2, "check": {"steps": 3, "sampled_vehicles": 2}})])
def test_slice_runs_on_the_cpu(cell, extra):
    """The slice's calls at tiny sizes on the CPU: one row per call or step,
    the marks of the solve (and of the step), on the host clock."""
    args = core.parse(["--workload", cell, "--seed", "2147483711", "--seconds", "0.3",
                       "--trace", "1"])
    r = runner.Run(core.Cell(cell), args, torch.device("cpu"), time.perf_counter(),
                   {**TINY, **extra, "trace": {"calls": 3, "steps": 3}})
    st = stamped.run_slice(r)
    assert not st.device and st.rows.shape[0] == 3 and (st.rows > 0).all()
    assert {"solve.cost", "solve.update", "solve.tail"} <= set(st.rec["marks"])
    assert ("wb_loop.logs" in st.rec["marks"]) == (cell.endswith("fleet_b256"))
    assert stamped.Stamped(st.rec).stage_ms("solve.cost", "solve.tail") is None  # host clock
