"""The traced run's arithmetic: the slice's device busy time, ops and glue,
the window's idle share (the device time of its calls over its length) and
enqueue time, the idle gaps by host span, and a ``--trace 1`` run's result
line on the CPU."""

import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402
from portbench import trace as tr  # noqa: E402

from test_portbench_harness import TINY  # noqa: E402

KIND = "NVIDIA H100 80GB HBM3"


def ctx(ops, units=2, enq=(), window=(None, 1.0), span=(0, 10**6)):
    traced = {"ops": ops, "spans": [("traced",) + tuple(span)]}
    return tr.Context(traced, units, {"B": 1, "K": 64, "H": 10, "A": 11}, list(enq), window,
                      KIND)


@pytest.mark.parametrize("ops,busy_ns", [
    ([], 0),
    ([("k", 0, 100, "kernel")], 100),
    ([("a", 0, 100, "kernel"), ("b", 50, 100, "kernel")], 150),   # overlap counts once
    ([("a", 0, 100, "kernel"), ("b", 300, 50, "memcpy")], 150),   # a gap between
    ([("a", -50, 100, "kernel"), ("b", 10**6 - 20, 50, "kernel")], 70),  # clipped to the slice
])
def test_busy_time_is_the_union_of_device_ops(ops, busy_ns):
    assert ctx(ops).busy_ns() == busy_ns


def test_idle_share_over_the_window():
    read = tr.load_metric("device.idle_share").read
    assert read(ctx([], window=(0.75, 1.0))) == pytest.approx(25.0)
    assert read(ctx([("a", 0, 10**6, "kernel")], window=(None, 1.0))) is None


def test_enqueue_is_the_mean_over_the_window_calls():
    read = tr.load_metric("graphs.enqueue_ms").read
    assert read(ctx([], enq=[1e-4, 3e-4])) == pytest.approx(0.2)
    assert read(ctx([])) is None


def test_ops_per_call_and_glue():
    ops = [("void wb_cost_kernel<0, true, true>(float*)", 0, 10, "kernel"),
           ("CUDAFunctor_add", 20, 30, "kernel"), ("Memcpy HtoD", 60, 5, "memcpy")]
    c = ctx(ops, units=3)
    assert tr.load_metric("device.ops_per_call").read(c) == pytest.approx(1.0)
    assert tr.load_metric("solver.glue_ms").read(c) == pytest.approx(1e3 * 30e-9 / 3)


def test_top_ops_by_name():
    ops = [("a", 0, 5, "kernel"), ("b", 10, 7, "kernel"), ("a", 20, 5, "kernel")]
    ops += [(f"k{i}", 100 + i, 1, "kernel") for i in range(12)]
    top = tr.top_ops(ops)
    assert [n for n, _ in top[:2]] == ["a", "b"] and len(top) == 10
    assert top[0][1] == pytest.approx(10e-9) and top[1][1] == pytest.approx(7e-9)


def test_idle_gaps_by_host_span():
    traced = {"ops": [("k", 100, 100, "kernel"), ("k", 600, 100, "kernel")],
              "spans": [("traced", 0, 1000), ("enqueue", 0, 150), ("readback", 150, 500),
                        ("enqueue", 500, 1000)]}
    gaps = dict(tr.idle_gaps_by_span(traced))
    # a gap goes to the span it starts in: 0-100 and 700-1000 to enqueue, 200-600 to readback
    assert gaps["enqueue"] == pytest.approx(400e-9) and gaps["readback"] == pytest.approx(400e-9)
    assert tr.idle_gaps_by_span({"ops": [], "spans": []}) == []


@pytest.mark.parametrize("cell,extra", [("wb_att_k4096.serve_b1", {"B": 1}),
                                        ("wb_pos_k512.fleet_b256",
                                         {"B": 2, "check": {"steps": 3, "sampled_vehicles": 2}})])
def test_traced_run_result_line(cell, extra):
    """A ``--trace 1`` run on the CPU: the per-layer metrics in place of the
    end-to-end ones (the host-clock enqueue time where the cell has it; no
    device op, so no device metric), ``busy_s`` and ``window_s``, the
    breakdown, and the check as in an untraced run."""
    argv = ["--workload", cell, "--seed", "2147483711", "--seconds", "0.3", "--trace", "1"]
    out = io.StringIO()
    over = {**TINY, **extra, "trace": {"calls": 3, "steps": 3}}
    with redirect_stdout(out):
        rc = core.main(argv, device="cpu", overrides=over)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True, res
    names = {m["name"] for m in core.Cell(cell).metrics("per_layer")}
    assert set(res["metrics"]) <= names
    assert ("graphs.enqueue_ms" in res["metrics"]) == ("graphs.enqueue_ms" in names)
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
