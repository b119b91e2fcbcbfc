"""The reader of ``featurized_linear_share``: the share of executions whose
linear model ran as the featurized-linear kernel, read off a hand-built run
whose traces hold ``op.matmul_bias`` spans with and without the kernel's
name, and off a traced run of each flights cell on the CPU, whose plans
fuse every time."""

import time

import pytest

from raven_bench.harness import cell, layout
from raven_bench.tests.held_cells import reading
from repro_torch.serve import ManualClock, Trace

T0, T_END = 10.0, 20.0
CELLS = ["flights_lr.delay_report", "flights_lr.delay_power"]


def _read(run):
    return layout.module("metrics", "featurized_linear_share").read(run)


def _run(records):
    return cell.Run("x", {}, {}, T_END - T0, 0.0, T0, T_END, records,
                    {}, {}, {}, None, {})


def _request(clock, start, spans):
    """One request whose execution, begun at ``start``, holds ``spans``
    (name, attributes); None for a request with no execution."""
    clock.set_time(start)
    tr = Trace(clock)
    if spans is not None:
        with tr.span("execute"):
            for name, attrs in spans:
                with tr.span(name, **attrs):
                    clock.advance(0.001)
    tr.finish()
    return cell.Record(None, start, clock.monotonic() + 0.01, True, trace=tr)


FUSED = ("op.matmul_bias", {"nid": "m", "kernel": "featurized_linear"})
PLAIN = ("op.matmul_bias", {"nid": "m"})


def test_share_counts_fused_executions_over_those_with_a_linear_model():
    clock = ManualClock()
    recs = [_request(clock, 11.0, [("op.featurize", {}), FUSED]),
            _request(clock, 12.0, [FUSED, FUSED]),        # chunked: fused
            _request(clock, 13.0, [FUSED, PLAIN]),        # a chunk unfused
            _request(clock, 14.0, [("op.featurize", {}), PLAIN]),
            _request(clock, 15.0, [("op.scan", {})]),     # no linear model
            _request(clock, 16.0, None),                  # coalesced
            _request(clock, 9.0, [PLAIN])]                # before the window
    assert _read(_run(recs)) == pytest.approx(50.0)
    # the parent's spans carry no kernel: 0, not missing
    assert _read(_run(recs[3:4])) == 0.0
    assert _read(_run(recs[4:6])) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_fuses_every_execution(name):
    r = cell.run_cell(name, 2**31 + 29, 1.0, True, time.monotonic(),
                      device="cpu", scale=0.005)
    assert r["correct"], r["checks"]
    assert reading(r["metrics"], "featurized_linear_share") == 100.0
