"""What a run records of its own process around its window, so that runs
whose numbers spread can be put into modes: the CPUs its threads ran on,
the CPU time it took, the garbage collector's pauses, the order in which
the execution lane was granted, each query shape's times, and the share of
a column that each drawn threshold lets through.  Everything here reads,
and nothing runs inside the window but the collector's callback.  The
record goes to the run's log in ``_runs/``, never to the result line.
"""

from __future__ import annotations

import gc
import resource
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


def _cpus() -> Dict[str, int]:
    """The CPU each of this process's threads last ran on, by thread id
    (``/proc/self/task/<tid>/stat``, field 39)."""
    out = {}
    for t in Path("/proc/self/task").glob("*"):
        try:
            text = (t / "stat").read_text()
        except OSError:
            continue
        out[t.name] = int(text[text.rindex(")") + 2:].split()[36])
    return out


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class Watch:
    """Started just before the window and stopped after it: the CPU each
    thread was on at both ends, the process's CPU time between them, and
    each garbage collection's generation and pause."""

    def __init__(self):
        self.gcs: List[Tuple[int, float]] = []
        self._gc_t0 = 0.0

    def _on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gcs.append((int(info["generation"]),
                             time.perf_counter() - self._gc_t0))

    def start(self) -> None:
        self.cpus0, self.cpu_s0 = _cpus(), _cpu_s()
        gc.callbacks.append(self._on_gc)

    def stop(self) -> None:
        gc.callbacks.remove(self._on_gc)
        self.cpus1, self.cpu_s1 = _cpus(), _cpu_s()

    def record(self) -> Dict:
        by_gen: Dict[str, List[float]] = {}
        for g, s in self.gcs:
            by_gen.setdefault(str(g), []).append(s)
        return {
            "thread_cpus": {tid: [self.cpus0.get(tid), self.cpus1.get(tid)]
                            for tid in sorted({*self.cpus0, *self.cpus1},
                                              key=int)},
            "cpu_s": self.cpu_s1 - self.cpu_s0,
            "gc": {g: {"count": len(v), "pause_s": sum(v), "max_s": max(v)}
                   for g, v in sorted(by_gen.items())},
            "gc_pause_s": sum(s for _, s in self.gcs),
        }


def overtaken_share(lanes: Iterable[Tuple[float, float]]) -> Optional[float]:
    """Of requests with a ``lane_wait`` span (release, grant), the share
    that a group released later got the lane before."""
    lanes = sorted(lanes)
    if not lanes:
        return None
    got = np.array([g for _, g in lanes])
    rel = np.array([r for r, _ in lanes])
    # the least grant from each position on; past the last one, none
    least = np.append(np.minimum.accumulate(got[::-1])[::-1], np.inf)
    later = least[np.searchsorted(rel, rel, side="right")]
    return float(np.mean(later < got))


def by_shape(records, execution_of, by_release) -> Dict[str, Dict]:
    """Per query shape: count, latency, ``parse`` and ``execute`` p50 (ms),
    and the plan's node sequence in its first execution."""
    out: Dict[str, Dict] = {}
    for r in records:
        shape = out.setdefault(r.req.query["name"], {
            "n": 0, "latency": [], "parse": [], "execute": [], "plan": None})
        shape["n"] += 1
        shape["latency"].append(r.latency)
        if r.trace is None:
            continue
        p = r.trace.find("parse")
        if p is not None and p.end is not None:
            shape["parse"].append(p.end - p.start)
        ex = execution_of(r, by_release)
        if ex is None or ex.end is None:
            continue
        shape["execute"].append(ex.end - ex.start)
        if shape["plan"] is None:
            shape["plan"] = [s.name for s in ex.walk()
                             if s.name.startswith("op.")]
    for shape in out.values():
        for k in ("latency", "parse", "execute"):
            v = shape.pop(k)
            shape[k + "_p50_ms"] = float(np.median(v)) * 1e3 if v else None
    return out


def pass_shares(records, columns: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Per ``uniform`` parameter: the thresholds drawn, as the share of
    the column's rows at or above them (mean, least, most), beside the
    column's own least and most value."""
    draws: Dict[Tuple[str, str], List[float]] = {}
    for r in records:
        for p in r.req.query.get("params", []):
            if p["kind"] == "uniform":
                draws.setdefault((p["name"], p["column"]), []).append(
                    r.req.binding[p["name"]])
    out = {}
    for (name, col), vals in draws.items():
        a = np.sort(columns[col])
        share = 1.0 - np.searchsorted(a, np.asarray(vals, a.dtype),
                                      side="left") / len(a)
        out[name] = {"column": col, "mean": float(share.mean()),
                     "min": float(share.min()), "max": float(share.max()),
                     "column_min": float(a[0]), "column_max": float(a[-1])}
    return out
