"""Median over the window's answered requests of the client's latency less
the ``execute`` span of the execution that answered it: the time a request
spends in the front door (parse, admission, queueing, stacking, slicing)
and, for a scoring request, its copy to the card."""

import numpy as np

from raven_bench.harness.cell import exec_spans, execution_of


def read(run):
    by = exec_spans(run.records)
    vals = []
    for r in run.completed:
        ex = execution_of(r, by)
        if ex is not None:
            vals.append(r.latency - (ex.end - ex.start))
    return float(np.median(vals)) * 1e3 if vals else None
