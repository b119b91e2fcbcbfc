"""The readers of the program's spans inside the query path: the wait for
the execution lane, each operator's device time, and the result cache's
reuse.  Each reads the exact value off a hand-built run whose traces hold
spans of known duration and ``device_ms``; a traced run of each flights
cell on the CPU gives a number for the two that need no card."""

import time

import pytest

from raven_bench.harness import cell, layout
from raven_bench.tests.held_cells import reading
from repro_torch.serve import ManualClock, Trace

T0, T_END = 10.0, 20.0
CELLS = ["flights_lr.delay_report", "flights_lr.delay_power"]


def _read(name, run):
    return layout.module("metrics", name).read(run)


def _run(records):
    return cell.Run("x", {}, {}, T_END - T0, 0.0, T0, T_END, records,
                    {}, {}, {}, None, {})


def _request(clock, release, lane_s, execute=None, issued=None):
    """One request's trace: released at ``release``, waits ``lane_s`` for
    the lane, then (unless coalesced: ``execute`` None) runs an execution
    whose children ``execute`` lists as (name, device_ms or None)."""
    clock.set_time(release - 0.5)
    tr = Trace(clock)
    tr.add_span("queue_wait", release - 0.5, release)
    tr.add_span("lane_wait", release, release + lane_s, own_flush=True)
    clock.set_time(release + lane_s)
    if execute is not None:
        with tr.span("execute"):
            for name, ms in execute:
                with tr.span(name) as s:
                    clock.advance(0.001)
                if ms is not None:
                    s.attrs["device_ms"] = ms
    tr.finish()
    start = release - 0.5 if issued is None else issued
    return cell.Record(None, start, clock.monotonic() + 0.01, True,
                       trace=tr)


def test_lane_wait_is_the_median_over_requests_answered_in_the_window():
    clock = ManualClock()
    recs = [_request(clock, 11.0, 0.004), _request(clock, 12.0, 0.100),
            _request(clock, 13.0, 0.250),
            _request(clock, 19.9, 7.0)]      # answered after the window
    assert _read("lane_wait_ms.p50", _run(recs)) == pytest.approx(100.0)
    assert _read("lane_wait_ms.p50", _run([])) is None


def test_operator_device_times_sum_within_an_execution():
    clock = ManualClock()
    one = [("op.scan", 0.0), ("op.featurize", 9.5), ("op.matmul_bias", 16.0)]
    chunked = [("op.featurize", 5.0), ("op.matmul_bias", 8.0),
               ("op.featurize", 6.0), ("op.matmul_bias", 9.0)]
    recs = [_request(clock, 11.0, 0.0, one),
            _request(clock, 12.0, 0.0, chunked),
            _request(clock, 13.0, 0.0, [("op.featurize", 12.0),
                                        ("op.matmul_bias", 19.0)]),
            _request(clock, 14.0, 0.0),          # coalesced: no execution
            _request(clock, 9.0, 0.0, one)]      # begun before the window
    run = _run(recs)
    assert _read("featurize_device_ms.p50", run) == pytest.approx(11.0)
    assert _read("matmul_bias_device_ms.p50", run) == pytest.approx(17.0)
    # on the CPU the spans carry no device time: nothing to read
    cpu = _run([_request(clock, 11.0, 0.0, [("op.featurize", None)])])
    assert _read("featurize_device_ms.p50", cpu) is None


def test_result_reuse_counts_splices_over_splices_and_captures():
    clock = ManualClock()
    capture = [("op.scan", None), ("result_capture", None)]
    splice = [("result_cache_splice", None)]
    recs = [_request(clock, 11.0, 0.0, capture),
            _request(clock, 12.0, 0.0, capture),
            _request(clock, 13.0, 0.0, capture),
            _request(clock, 14.0, 0.0, splice),
            _request(clock, 15.0, 0.0, [("op.scan", None)]),  # neither
            _request(clock, 9.0, 0.0, splice)]   # begun before the window
    assert _read("result_reuse_share", _run(recs)) == pytest.approx(25.0)
    assert _read("result_reuse_share", _run(recs[4:5])) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reads_the_lane_and_the_reuse(name):
    r = cell.run_cell(name, 2**31 + 11, 1.0, True, time.monotonic(),
                      device="cpu", scale=0.005)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    assert reading(got, "lane_wait_ms.p50") >= 0
    assert 0 <= reading(got, "result_reuse_share") <= 100
    # no card: the operators' device times are not there to read
    assert not [n for n in got if n.startswith(("featurize_device_ms.p50",
                                                 "matmul_bias_device_ms.p50"))]
