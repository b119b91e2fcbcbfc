"""Low-overhead request tracing + unified metrics registry.

Two independent pieces, both designed so the *off* switch costs nothing
on the hot path:

- ``Trace``/``Span``: a per-request span tree recorded against the
  service's injectable ``Clock`` (so ``ManualClock`` tests pin span
  durations exactly).  The serving threads open spans with
  ``trace.span(...)`` (a context manager keeping a lock-protected open
  stack — request phases are sequential in time even when they hop
  threads: submit thread -> admission loop -> per-group serve); shard
  and exchange *worker* threads, which genuinely overlap, record
  finished spans out-of-band with ``trace.add_span(...)`` carrying a
  ``tid`` (device index).  Work that may only run once the device has
  finished what the request launched (reading the CUDA events an
  executable recorded at its operator boundaries) is queued with
  ``trace.defer(fn)`` and run, if nothing ran it before, when the trace
  is read: tracing adds no sync to the request's path.  ``NULL_TRACE``
  is a shared no-op singleton:
  with ``telemetry=False`` every span site touches one attribute and
  one pre-built context manager, nothing else.

- ``MetricsRegistry``: counters, gauges and fixed-bucket histograms
  keyed by ``(name, labels)``, with pull-time *collectors* (the service
  registers its ``ServiceStats`` fields and ``cache_info()`` /
  ``admission_info()`` / ``tenant_info()`` dicts as
  collector callbacks, so those stay the single source of truth) and a
  Prometheus text-format ``render()``.  ``writes`` counts hot-path
  mutations — the telemetry-off tests assert it stays zero while the
  collector-backed gauges keep working (collection is a read).

Chrome-trace export: ``chrome_trace(traces)`` returns the
``{"traceEvents": [...]}`` JSON object loadable in Perfetto /
``chrome://tracing`` ("X" complete events, microsecond timestamps).
"""

from __future__ import annotations

import itertools
import json
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["Span", "Trace", "NULL_TRACE", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "chrome_trace"]

# Latency histogram buckets (seconds): 100us .. 10s, roughly log-spaced.
# Fixed so series are comparable across processes and releases.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Span:
    """One timed phase of a request.  ``start``/``end`` are clock-domain
    seconds (the service's injected ``Clock``); ``tid`` groups spans into
    Chrome-trace tracks (0 = the request's own track, 1+N = device N)."""

    __slots__ = ("name", "start", "end", "attrs", "children", "tid")

    def __init__(self, name: str, start: float, tid: int = 0,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs or {}
        self.children: List["Span"] = []
        self.tid = tid

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration * 1e3:.3f}ms, "
                f"attrs={self.attrs})")


class _SpanCtx:
    __slots__ = ("_trace", "_span")

    def __init__(self, trace: "Trace", span: Span):
        self._trace = trace
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._trace._close(self._span, failed=exc_type is not None)
        return False


class Trace:
    """Span tree for one request.  Thread-safe: phase spans nest through a
    lock-protected open-span stack (phases are sequential in time even
    across thread handoffs); concurrent worker threads use ``add_span``,
    which parents under whichever phase span is open at record time."""

    enabled = True

    def __init__(self, clock, trace_id: int = 0, name: str = "request",
                 attrs: Optional[Dict[str, Any]] = None):
        self.clock = clock
        self.trace_id = trace_id
        self.name = name
        self.attrs: Dict[str, Any] = attrs or {}
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self._deferred: List[Callable[[], bool]] = []
        self._lock = threading.Lock()
        self.started: float = clock.monotonic()
        self.finished: Optional[float] = None

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs) -> _SpanCtx:
        s = Span(name, self.clock.monotonic(), attrs=attrs)
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            (parent.children if parent else self.roots).append(s)
            self._stack.append(s)
        return _SpanCtx(self, s)

    def _close(self, span: Span, failed: bool = False) -> None:
        span.end = self.clock.monotonic()
        if failed:
            span.attrs.setdefault("error", True)
        with self._lock:
            # pop through span: tolerates a worker's add_span in between
            while self._stack and self._stack.pop() is not span:
                pass

    def add_span(self, name: str, start: float, end: float, tid: int = 0,
                 **attrs) -> Span:
        """Record an already-timed span (worker threads: shard waves,
        exchange buckets).  Parents under the currently open phase span."""
        s = Span(name, start, tid=tid, attrs=attrs)
        s.end = end
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            (parent.children if parent else self.roots).append(s)
        return s

    def event(self, name: str, **attrs) -> Span:
        """Zero-duration marker (shed, coalesced, cache decisions)."""
        now = self.clock.monotonic()
        return self.add_span(name, now, now, **attrs)

    def defer(self, fn: Callable[[], bool]) -> None:
        """Queue ``fn`` until the trace is read: work that needs the
        device to have finished what the request launched, such as
        reading CUDA events.  ``fn`` returns False while it cannot run
        yet, and is kept for the next read."""
        with self._lock:
            self._deferred.append(fn)

    def settle(self) -> None:
        """Run the deferred work that can run now; every read of the
        spans does this first."""
        with self._lock:
            fns, self._deferred = self._deferred, []
        left = [fn for fn in fns if not fn()]
        if left:
            with self._lock:
                self._deferred[:0] = left

    def finish(self) -> None:
        if self.finished is None:
            self.finished = self.clock.monotonic()

    # -- reading -----------------------------------------------------------

    @property
    def total_s(self) -> float:
        end = self.finished if self.finished is not None \
            else self.clock.monotonic()
        return end - self.started

    def spans(self) -> Iterator[Span]:
        self.settle()
        for r in self.roots:
            yield from r.walk()

    def find(self, name: str) -> Optional[Span]:
        for s in self.spans():
            if s.name == name:
                return s
        return None

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans()]

    def pretty(self) -> str:
        self.settle()
        lines = [f"trace #{self.trace_id} {self.name} "
                 f"({self.total_s * 1e3:.3f}ms) {self.attrs or ''}".rstrip()]

        def fmt(span: Span, depth: int):
            attrs = " ".join(f"{k}={v}" for k, v in span.attrs.items())
            lines.append(f"{'  ' * depth}- {span.name} "
                         f"{span.duration * 1e3:.3f}ms"
                         + (f" [{attrs}]" if attrs else ""))
            for c in span.children:
                fmt(c, depth + 1)

        for r in self.roots:
            fmt(r, 1)
        return "\n".join(lines)

    def to_chrome_events(self, pid: int = 0) -> List[Dict[str, Any]]:
        """Chrome-trace "X" (complete) events, microsecond clock domain."""
        events: List[Dict[str, Any]] = []
        for s in self.spans():
            events.append({
                "name": s.name, "ph": "X", "pid": pid,
                "tid": s.tid,
                "ts": round(s.start * 1e6, 3),
                "dur": round(max(0.0, s.duration) * 1e6, 3),
                "args": {k: (v if isinstance(v, (int, float, str, bool))
                             or v is None else repr(v))
                         for k, v in s.attrs.items()},
            })
        return events


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CTX = _NullCtx()


class _NullTrace:
    """Shared do-nothing trace: the ``telemetry=off`` hot path."""

    enabled = False
    trace_id = 0
    name = "null"
    attrs: Dict[str, Any] = {}
    roots: List[Span] = []
    started = 0.0
    finished: Optional[float] = 0.0

    def span(self, name: str, **attrs) -> _NullCtx:
        return _NULL_CTX

    def add_span(self, name: str, start: float, end: float, tid: int = 0,
                 **attrs) -> None:
        return None

    def event(self, name: str, **attrs) -> None:
        return None

    def defer(self, fn: Callable[[], bool]) -> None:
        return None

    def settle(self) -> None:
        return None

    def finish(self) -> None:
        return None

    @property
    def total_s(self) -> float:
        return 0.0

    def spans(self):
        return iter(())

    def find(self, name: str):
        return None

    def span_names(self) -> List[str]:
        return []

    def pretty(self) -> str:
        return "trace disabled"

    def to_chrome_events(self, pid: int = 0) -> List[Dict[str, Any]]:
        return []


NULL_TRACE = _NullTrace()


def chrome_trace(traces, path: Optional[str] = None) -> Dict[str, Any]:
    """Fold traces into one Chrome-trace/Perfetto JSON object (each trace
    becomes a ``pid`` with its spans as complete events).  Optionally
    writes it to ``path``."""
    events: List[Dict[str, Any]] = []
    for i, t in enumerate(traces):
        pid = t.trace_id or i
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"{t.name} #{t.trace_id}"}})
        events.extend(t.to_chrome_events(pid=pid))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1)
    return doc


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

_LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, Any]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[len(self.buckets)] += 1
        self.sum += value
        self.count += 1


class MetricsRegistry:
    """Counters, gauges and fixed-bucket histograms behind one lock, plus
    pull-time collectors.  A collector is ``fn() -> iterable`` of
    ``(name, kind, value, labels)`` tuples (kind ``"counter"`` or
    ``"gauge"``) sampled at ``snapshot()``/``render()`` time — reads,
    not writes, so they work with telemetry off.  ``writes`` counts every
    hot-path mutation (inc/set_gauge/observe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], float] = {}
        self._hists: Dict[Tuple[str, _LabelKey], _Histogram] = {}
        self._collectors: List[Callable[[], Any]] = []
        self.writes = 0

    # -- hot-path writes ---------------------------------------------------

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, Any]] = None) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value
            self.writes += 1

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, Any]] = None) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._gauges[key] = float(value)
            self.writes += 1

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, Any]] = None,
                buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram(buckets)
            h.observe(float(value))
            self.writes += 1

    # -- pull-time reads ---------------------------------------------------

    def add_collector(self, fn: Callable[[], Any]) -> Callable[[], None]:
        """Register a pull-time sampler; returns an unsubscriber."""
        self._collectors.append(fn)

        def unsubscribe():
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass
        return unsubscribe

    def _collected(self):
        for fn in list(self._collectors):
            for name, kind, value, labels in fn():
                yield name, kind, float(value), _labels_key(labels)

    def snapshot(self) -> Dict[str, Any]:
        """One queryable dict: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{k=v,...}`` flat keys."""
        def flat(name: str, lk: _LabelKey) -> str:
            if not lk:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"

        with self._lock:
            counters = {flat(n, lk): v
                        for (n, lk), v in self._counters.items()}
            gauges = {flat(n, lk): v for (n, lk), v in self._gauges.items()}
            hists = {flat(n, lk): {"sum": h.sum, "count": h.count,
                                   "buckets": list(zip(h.buckets, h.counts))}
                     for (n, lk), h in self._hists.items()}
        for name, kind, value, lk in self._collected():
            (counters if kind == "counter" else gauges)[flat(name, lk)] = \
                value
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def render(self) -> str:
        """Prometheus text exposition format."""
        def labels_str(lk: _LabelKey, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in lk]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (h.buckets, list(h.counts), h.sum, h.count)
                     for k, h in self._hists.items()}
        for name, kind, value, lk in self._collected():
            # collectors export absolute samples (stats fields, info dicts)
            # under their own metric names — no merging with hot-path keys
            (counters if kind == "counter" else gauges)[(name, lk)] = value

        lines: List[str] = []
        seen_type: set = set()

        def typed(name: str, kind: str):
            if name not in seen_type:
                lines.append(f"# TYPE {name} {kind}")
                seen_type.add(name)

        for (name, lk), v in sorted(counters.items()):
            typed(name, "counter")
            lines.append(f"{name}{labels_str(lk)} {v:g}")
        for (name, lk), v in sorted(gauges.items()):
            typed(name, "gauge")
            lines.append(f"{name}{labels_str(lk)} {v:g}")
        for (name, lk), (buckets, counts, total, count) in \
                sorted(hists.items()):
            typed(name, "histogram")
            cum = 0
            for b, c in zip(buckets, counts[:-1]):
                cum += c
                le = 'le="%g"' % b
                lines.append(f"{name}_bucket{labels_str(lk, le)} {cum}")
            cum += counts[-1]
            inf = 'le="+Inf"'
            lines.append(f"{name}_bucket{labels_str(lk, inf)} {cum}")
            lines.append(f"{name}_sum{labels_str(lk)} {total:g}")
            lines.append(f"{name}_count{labels_str(lk)} {count}")
        return "\n".join(lines) + "\n"


_trace_ids = itertools.count(1)


def next_trace_id() -> int:
    return next(_trace_ids)
