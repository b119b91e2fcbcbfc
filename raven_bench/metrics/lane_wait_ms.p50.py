"""Median over the window's answered requests of their ``lane_wait`` span:
from the release of the request's group (where its ``queue_wait`` ends)
until the thread serving the group holds the execution lane."""

import numpy as np


def read(run):
    vals = []
    for r in run.completed:
        lane = r.trace.find("lane_wait") if r.trace is not None else None
        if lane is not None:
            vals.append(lane.end - lane.start)
    return float(np.median(vals)) * 1e3 if vals else None
