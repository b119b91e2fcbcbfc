"""Reading the profiler's trace of the measured window.

Device intervals come from ``torch.profiler``'s raw events (kernels,
copies and sets on the card).  Their clock is the profiler's; an
annotation opened at a known ``time.monotonic()`` reading puts them on the
clock the service's spans use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

WINDOW_MARK = "raven_bench.window"


@dataclasses.dataclass
class DeviceTrace:
    names: List[str]          # one per device interval
    start: np.ndarray         # seconds, monotonic clock
    end: np.ndarray
    w0: float                 # the traced window
    w1: float

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def union(self) -> np.ndarray:
        """Merged busy intervals inside the window, [m, 2]."""
        s = np.clip(self.start, self.w0, self.w1)
        e = np.clip(self.end, self.w0, self.w1)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        out: List[Tuple[float, float]] = []
        for a, b in zip(s, e):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return np.asarray(out, dtype=np.float64).reshape(-1, 2)

    def busy_s(self) -> float:
        u = self.union()
        return float((u[:, 1] - u[:, 0]).sum())

    def gaps(self) -> np.ndarray:
        """Idle intervals of the window, [g, 2]."""
        u = self.union()
        edges = np.concatenate([[self.w0], u.ravel(), [self.w1]])
        g = edges.reshape(-1, 2)
        return g[g[:, 1] > g[:, 0]]

    def seconds_by_name(self) -> Dict[str, float]:
        s = np.clip(self.start, self.w0, self.w1)
        e = np.clip(self.end, self.w0, self.w1)
        out: Dict[str, float] = {}
        for name, d in zip(self.names, e - s):
            out[name] = out.get(name, 0.0) + float(d)
        return out

    def seconds_matching(self, part: str) -> float:
        return sum(v for k, v in self.seconds_by_name().items()
                   if part in k)


def read(prof, mark_monotonic: float, w0: float, w1: float) -> DeviceTrace:
    """The device intervals of a finished ``torch.profiler.profile``.
    ``mark_monotonic`` is the ``time.monotonic()`` reading taken as the
    ``WINDOW_MARK`` annotation opened."""
    events = prof.profiler.kineto_results.events()
    mark = None
    names, starts, ends = [], [], []
    for ev in events:
        if ev.name() == WINDOW_MARK and mark is None:
            mark = ev.start_ns()
        elif ev.device_type().name == "CUDA":
            names.append(ev.name())
            starts.append(ev.start_ns())
            ends.append(ev.start_ns() + ev.duration_ns())
    if mark is None:
        raise RuntimeError("the profiler kept no window annotation")
    off = mark_monotonic - mark * 1e-9
    return DeviceTrace(names, np.asarray(starts, np.float64) * 1e-9 + off,
                       np.asarray(ends, np.float64) * 1e-9 + off, w0, w1)


def open_spans(intervals: Dict[str, Sequence[Tuple[float, float]]],
               points: np.ndarray, order: Sequence[str]) -> List[str]:
    """For each point, the first name in ``order`` whose intervals hold it,
    or ``none``."""
    out = np.full(len(points), "none", dtype=object)
    left = np.ones(len(points), bool)
    for name in order:
        iv = sorted(intervals.get(name, ()))
        if not iv:
            continue
        merged: List[List[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        m = np.asarray(merged)
        i = np.searchsorted(m[:, 0], points, side="right") - 1
        inside = (i >= 0) & (points <= m[np.maximum(i, 0), 1])
        hit = left & inside
        out[hit] = name
        left &= ~inside
    return list(out)
