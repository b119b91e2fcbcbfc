"""The run's mode record: the share of requests overtaken for the lane,
each shape's times, the thresholds' pass shares, and the watch over the
window's threads and garbage collections."""

import gc
import time

import numpy as np
import pytest

from raven_bench.harness import cell, modes
from raven_bench.harness.traffic import Request
from repro_torch.serve import ManualClock, Trace


@pytest.mark.parametrize("lanes, share", [
    ([], None),
    ([(1.0, 1.1), (2.0, 2.1), (3.0, 3.1)], 0.0),       # in order
    ([(1.0, 2.5), (2.0, 2.1)], 0.5),                   # the first overtaken
    ([(1.0, 3.0), (1.0, 3.0), (2.0, 2.5)], 2 / 3),     # a group of two
    ([(1.0, 1.5), (1.0, 1.5)], 0.0),                   # one group alone
    ([(1.0, 4.0), (2.0, 3.0), (3.0, 2.5)], 2 / 3),
])
def test_overtaken_share(lanes, share):
    got = modes.overtaken_share(lanes)
    assert got == (None if share is None else pytest.approx(share))


def _rec(clock, name, t, execute_s, binding):
    clock.set_time(t)
    tr = Trace(clock)
    tr.add_span("parse", t, t + 0.001)
    tr.add_span("queue_wait", t + 0.001, t + 0.002)
    clock.set_time(t + 0.002)
    with tr.span("execute"):
        with tr.span("op.scan"):
            pass
        with tr.span("op.matmul_bias") as s:
            clock.advance(execute_s)
        s.attrs["device_ms"] = 1.0
    tr.finish()
    q = {"name": name, "params": [{"kind": "uniform", "name": "d",
                                   "column": "x", "domain": [0, 10]}]}
    req = Request("analyst", 0, 0, q, binding)
    return cell.Record(req, t, t + 0.002 + execute_s, True, trace=tr)


def test_shapes_and_pass_shares():
    clock = ManualClock()
    recs = [_rec(clock, "a", 1.0, 0.003, {"d": 2.5}),
            _rec(clock, "a", 2.0, 0.005, {"d": 7.5}),
            _rec(clock, "b", 3.0, 0.010, {"d": 0.0})]
    shapes = modes.by_shape(recs, cell.execution_of, cell.exec_spans(recs))
    assert shapes["a"]["n"] == 2 and shapes["b"]["n"] == 1
    assert shapes["a"]["execute_p50_ms"] == pytest.approx(4.0)
    assert shapes["a"]["parse_p50_ms"] == pytest.approx(1.0)
    assert shapes["a"]["plan"] == ["op.scan", "op.matmul_bias"]
    cols = {"x": np.arange(10, dtype=np.float32)}      # 0 .. 9
    got = modes.pass_shares(recs, cols)["d"]
    assert got["mean"] == pytest.approx((0.7 + 0.2 + 1.0) / 3)
    assert (got["min"], got["max"]) == (pytest.approx(0.2), 1.0)
    assert (got["column_min"], got["column_max"]) == (0.0, 9.0)


def test_the_watch_sees_threads_and_collections():
    w = modes.Watch()
    w.start()
    junk = [[i] for i in range(50_000)]
    gc.collect()
    t = time.monotonic()
    while time.monotonic() - t < 0.1:
        pass
    del junk
    w.stop()
    rec = w.record()
    assert rec["gc"]["2"]["count"] >= 1 and rec["gc_pause_s"] > 0
    assert rec["cpu_s"] > 0.05
    assert rec["thread_cpus"] and all(
        isinstance(c, int) for ends in rec["thread_cpus"].values()
        for c in ends if c is not None)
