"""Median of the service's ``execute`` spans begun in the window: one
execution of an optimized plan's closure, its result synchronized."""

import numpy as np


def read(run):
    spans = {}
    for r in run.records:
        ex = r.trace.find("execute") if r.trace is not None else None
        if ex is not None and run.t0 <= ex.start <= run.t_end:
            spans[id(ex)] = ex.end - ex.start
    return float(np.median(list(spans.values()))) * 1e3 if spans else None
