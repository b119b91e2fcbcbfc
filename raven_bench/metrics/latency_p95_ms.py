"""95th percentile latency of the requests answered in the window, from
the moment the client issued each (before it copies its rows to the
card)."""

import numpy as np


def read(run):
    lat = [r.latency for r in run.completed]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
