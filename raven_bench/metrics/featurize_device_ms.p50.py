"""Median over the executions begun in the window of their featurizers'
device time: the sum of the ``device_ms`` of the ``op.featurize`` spans
under each ``execute`` span (the card's stream time from the node's
boundary event to the next node's; one span a node a call of the
closure, so a chunked execution sums its chunks)."""

import numpy as np


def device_ms(run, op):
    """The median, over executions begun in the window, of the summed
    ``device_ms`` of their ``op`` spans, or None where none has one."""
    per = {}
    for r in run.records:
        ex = r.trace.find("execute") if r.trace is not None else None
        if ex is None or id(ex) in per or not run.t0 <= ex.start <= run.t_end:
            continue
        ms = [s.attrs["device_ms"] for s in ex.walk()
              if s.name == op and "device_ms" in s.attrs]
        if ms:
            per[id(ex)] = sum(ms)
    return float(np.median(list(per.values()))) if per else None


def read(run):
    return device_ms(run, "op.featurize")
