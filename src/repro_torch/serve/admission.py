"""Admission control for continuous prediction-query batching.

``serve/engine.py`` runs continuous batching for *tokens*: a background
loop refills fixed decode slots from an admission queue at every step
boundary.  This module is the same idea for *prediction queries*: requests
accumulate in a bounded queue, group by executable-cache key, and a group
flushes when any of

- the **latency budget** of its oldest request is about to expire
  (``AdmissionConfig.latency_budget_s``),
- the group reached ``max_batch_requests`` (no point waiting longer), or
- a caller forces a drain (explicit ``flush()`` / service ``close()``).

Everything here is deliberately free of torch and of the service itself —
the :class:`Batcher` holds opaque *items* grouped under opaque *keys*, and
the :class:`AdmissionLoop` thread only talks to the batcher plus a
``serve`` callback.  Two seams make the loop testable without real sleeps:

- an injectable :class:`Clock` — :class:`SystemClock` in production,
  :class:`ManualClock` in tests (time only moves when the test calls
  ``advance``; waits return immediately so nothing ever blocks on a fake
  timestamp);
- **event hooks** — ``Batcher.on_admit(item)`` and ``Batcher.on_flush(key,
  items, reason)`` fire synchronously at admission and at group pop, so a
  test can observe exactly which requests coalesced and *why* a group was
  released (reason is one of ``"deadline" | "full" | "drain"``).

Backpressure: ``Batcher.offer`` blocks while the queue holds
``max_queue`` items (producers slow to the service's drain rate).  With
``block_on_full=False`` — or when ``offer_timeout_s`` expires — it raises
:class:`AdmissionQueueFull` instead, so callers can shed load rather than
pile up unbounded work behind a wedged executor.

**Multi-tenancy**: offers carrying a :class:`RequestContext` land in the
per-tenant queue named by ``ctx.tenant`` (``None`` — every context-less
offer — is the default tenant).  Groups never span tenants.  Three things
change versus the single queue, and only when more than one tenant holds
due work:

- **drain order** — ``pop_ready`` releases every due group, but orders the
  released list by weighted deficit-round-robin across tenants
  (``TenantPolicy.weight``), so downstream execution order — and therefore
  queue latency under saturation — is fair rather than FIFO-by-arrival;
  within a tenant, higher ``ctx.priority`` groups drain first.
- **backpressure** — a tenant with ``TenantPolicy.max_queue`` blocks (or
  sheds) against its *own* bound; the global ``max_queue`` still bounds the
  total.  A flooding tenant therefore fills its own queue and starts
  rejecting while its neighbors keep admitting.
- **deadlines** — ``ctx.deadline_s`` tightens (never loosens) the
  service-wide latency budget for that request's group.

With a single tenant (the entire pre-context API), every one of these
reduces exactly to the old single-queue behavior.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from .context import RequestContext

__all__ = ["AdmissionConfig", "AdmissionLoop", "AdmissionQueueFull",
           "Batcher", "Clock", "DeadlineUnmeetable", "ManualClock",
           "ReadyGroup", "SystemClock"]


class AdmissionQueueFull(RuntimeError):
    """The bounded admission queue stayed full past the offer timeout."""


class DeadlineUnmeetable(RuntimeError):
    """The request's ``ctx.deadline_s`` cannot possibly be met: the
    observed queue-wait EWMA plus the calibrated execution estimate for
    its plan already exceed the deadline, so admitting it would only serve
    it late.  Raised at admission (``PredictionService.submit``) so the
    caller can shed or retry elsewhere instead of burning a queue slot on
    a doomed request."""


# ---------------------------------------------------------------------------
# Clock seam.
# ---------------------------------------------------------------------------

class Clock:
    """Time source + condition-wait used by the batcher and loop.  The
    indirection exists so deadline logic can be driven by a test-controlled
    timestamp instead of ``time.monotonic`` + real sleeps."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def wait(self, cond: threading.Condition, timeout: float) -> bool:
        """Wait on ``cond`` (held by the caller) up to ``timeout`` seconds.
        Returns True if notified before the timeout."""
        raise NotImplementedError


class SystemClock(Clock):
    def monotonic(self) -> float:
        return time.monotonic()

    def wait(self, cond: threading.Condition, timeout: float) -> bool:
        return cond.wait(timeout)


class ManualClock(Clock):
    """Deterministic clock: ``monotonic()`` returns a test-set value and
    only ``advance()``/``set_time()`` move it.  ``wait`` yields the lock
    briefly (never sleeping out the fake timeout), so a loop accidentally
    run against a ManualClock degrades to polling instead of hanging."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def advance(self, dt: float) -> float:
        with self._lock:
            self._now += float(dt)
            return self._now

    def set_time(self, t: float) -> None:
        with self._lock:
            self._now = float(t)

    def wait(self, cond: threading.Condition, timeout: float) -> bool:
        return cond.wait(min(timeout, 0.005))


# ---------------------------------------------------------------------------
# Configuration.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Continuous-batching knobs (see ``PredictionService`` docstring).

    - ``latency_budget_s`` — how long an admitted request may wait for
      batch-mates before its group is flushed.  The p95 queue latency is
      bounded by roughly this plus one batch execution.
    - ``max_queue`` — bound on queued requests across all groups; at the
      bound ``offer`` blocks (backpressure) or raises
      :class:`AdmissionQueueFull` (``block_on_full=False`` / timeout).
    - ``max_batch_requests`` — a group this large flushes immediately.
    - ``min_bucket_rows`` / ``max_bucket_rows`` — row-bucket policy for
      shape-bucketed executables: stacked batches pad to the next
      power-of-two bucket in ``[min, max]``, so any batch size maps to one
      of O(log max/min) compiled shapes.
    - ``background`` — start the :class:`AdmissionLoop` thread.  Off for
      deterministic tests that drive ``admission_tick`` by hand.
    - ``adaptive_latency`` — SLO-aware flush window: instead of the fixed
      ``latency_budget_s``, the effective budget tracks an EWMA of queue
      depth and slides between ``min_latency_budget_s`` (idle: serve
      immediately, nobody is coming to coalesce with) and
      ``max_latency_budget_s`` (deep queue: wait longer, bigger batches
      amortize better), saturating when the smoothed depth reaches
      ``max_batch_requests``.  The EWMA updates at admission and release
      events (``adaptive_alpha`` smoothing), so it is fully deterministic
      under a :class:`ManualClock`.
    - ``max_tenant_compiles`` — cap on *cold* (uncompiled-signature)
      groups released per tenant per ``pop_ready`` pass (0 = unlimited).
      A tenant minting novel plan signatures otherwise monopolizes the
      serve thread with cold compiles and starves compliant tenants' warm
      path: with the cap, excess cold groups simply stay queued behind
      the tenant's own DRR slot and release on later passes, so other
      tenants' due work interleaves between compiles.  Needs the
      ``Batcher.is_cold`` seam (the service injects an executable-cache
      peek); warm groups are never deferred, and ``drain()`` ignores the
      cap — an explicit flush leaves nothing behind.
    - ``max_staleness_s`` — service-wide freshness SLA default under
      streaming ingest: requests that carry no
      ``RequestContext.max_staleness_s`` (and whose tenant policy sets
      none) inherit this budget.  A request whose only missed cache key is
      an *append* within the budget may then be answered from the
      pre-append snapshot instead of computing the delta (None = always
      serve the current version; the conservative default).
    """

    latency_budget_s: float = 0.002
    max_queue: int = 1024
    max_batch_requests: int = 64
    min_bucket_rows: int = 64
    max_bucket_rows: int = 1 << 20
    block_on_full: bool = True
    offer_timeout_s: float = 30.0
    background: bool = True
    adaptive_latency: bool = False
    min_latency_budget_s: float = 5e-4
    max_latency_budget_s: float = 8e-3
    adaptive_alpha: float = 0.2
    max_tenant_compiles: int = 0
    max_staleness_s: Optional[float] = None


@dataclasses.dataclass
class _Admitted:
    key: Any
    item: Any
    admitted_at: float
    chunk: bool = True        # False: group must release whole (see offer)
    ctx: Optional[RequestContext] = None


@dataclasses.dataclass
class ReadyGroup:
    """A coalesced batch released by the batcher, plus why it released.

    ``ctx`` is the request context of the group's oldest member (groups are
    tenant-homogeneous, so ``ctx.tenant`` attributes the whole batch)."""

    key: Any
    items: List[Any]
    reason: str                        # "deadline" | "full" | "drain"
    admitted_at: Tuple[float, ...] = ()
    ctx: Optional[RequestContext] = None


def _hook_arity(hook: Callable) -> Optional[int]:
    """Positional-parameter count of ``hook``, ``None`` when it takes
    ``*args`` (pass everything) — used to keep pre-context hooks working
    unchanged while offering context-aware hooks the extra argument."""
    try:
        sig = inspect.signature(hook)
    except (TypeError, ValueError):      # C callables without signatures
        return None
    count = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return None
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            count += 1
    return count


def _fire_hook(hook: Callable, *args: Any) -> None:
    """Call ``hook`` with as many of ``args`` as it accepts; the last
    argument is the request context, which legacy hooks don't take."""
    n = _hook_arity(hook)
    if n is None:
        try:
            hook(*args)
        except TypeError:
            hook(*args[:-1])
        return
    hook(*args) if n >= len(args) else hook(*args[:-1])


# ---------------------------------------------------------------------------
# Batcher.
# ---------------------------------------------------------------------------

class Batcher:
    """Bounded, key-grouped admission queue shared by the explicit-flush
    path and the background loop.  Thread-safe; all waiting happens on
    ``self.cond`` (one condition for producers awaiting space, the loop
    awaiting work, and ``stop`` wakeups — predicates are re-checked after
    every wait, so ``notify_all`` keeps everyone honest).

    Requests live in per-tenant sub-queues (``ctx.tenant``; ``None`` for
    every context-less offer).  ``tenant_policies`` maps tenant name to
    :class:`~repro_torch.serve.context.TenantPolicy` — the mapping is held by
    reference, so policies registered later apply to queued work."""

    def __init__(self, config: AdmissionConfig, clock: Optional[Clock] = None,
                 tenant_policies: Optional[Mapping[str, Any]] = None):
        if config.adaptive_latency \
                and config.min_latency_budget_s > config.max_latency_budget_s:
            raise ValueError(
                f"adaptive latency window inverted: min "
                f"{config.min_latency_budget_s} > max "
                f"{config.max_latency_budget_s}")
        self.config = config
        self.clock = clock or SystemClock()
        self.tenant_policies: Mapping[str, Any] = \
            tenant_policies if tenant_policies is not None else {}
        # RLock so the loop can call next_deadline()/has_ready() while
        # already holding cond (single source of truth for readiness)
        self.cond = threading.Condition(threading.RLock())
        self._queues: Dict[Optional[str], List[_Admitted]] = {}
        self._depth_ewma = 0.0
        self._closed = False
        self.rejections: Dict[Optional[str], int] = {}
        # ``max_tenant_compiles`` seam: the service injects a predicate
        # answering "would serving this batch key compile cold right
        # now?" (an executable-cache peek).  None disables the cap.
        self.is_cold: Optional[Callable[[Any], bool]] = None
        self.compile_deferrals = 0       # cold groups held back by the cap
        self.depth_high_water = 0        # max total depth ever observed
        # test/observability seams — called synchronously, outside cond.
        # Hooks may take the legacy shapes ``on_admit(item)`` /
        # ``on_flush(key, items, reason)`` or append a trailing
        # ``ctx: RequestContext`` parameter for per-tenant attribution.
        self.on_admit: Optional[Callable] = None
        self.on_flush: Optional[Callable] = None

    def __len__(self) -> int:
        with self.cond:
            return self._total()

    def _total(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth(self, tenant: Optional[str] = None) -> int:
        """Queued requests of one tenant (``None`` = default queue)."""
        with self.cond:
            return len(self._queues.get(tenant, ()))

    def depths(self) -> Dict[Optional[str], int]:
        with self.cond:
            return {t: len(q) for t, q in self._queues.items() if q}

    def _tenant_max(self, tenant: Optional[str]) -> int:
        policy = self.tenant_policies.get(tenant) if tenant is not None \
            else None
        if policy is not None and policy.max_queue is not None:
            return max(int(policy.max_queue), 1)
        return max(self.config.max_queue, 1)

    def _tenant_weight(self, tenant: Optional[str]) -> float:
        policy = self.tenant_policies.get(tenant) if tenant is not None \
            else None
        if policy is None:
            return 1.0
        return max(float(policy.weight), 1e-6)

    # -- producer side -------------------------------------------------------
    def offer(self, key: Any, item: Any, chunk: bool = True,
              ctx: Optional[RequestContext] = None) -> None:
        """Admit ``item`` under ``key``; blocks while the queue is full
        (raises :class:`AdmissionQueueFull` on timeout / non-blocking).
        The offer timeout runs on *wall* time, not the injectable clock:
        backpressure bounds how long a producer really blocks, and a
        ManualClock that never advances must not turn a full queue into an
        unbounded spin.

        ``chunk=False`` marks requests whose group must release whole
        regardless of ``max_batch_requests`` — identical-catalog-table
        prediction requests all share ONE execution however many coalesce,
        so splitting them only multiplies full-plan executions.  The cap
        still *triggers* their flush; it just never splits them.

        ``ctx`` routes the item to its tenant's queue and is checked
        against both the global ``max_queue`` and the tenant's own
        ``TenantPolicy.max_queue`` — a flooding tenant blocks/sheds on its
        own bound without consuming its neighbors' admission capacity."""
        cfg = self.config
        tenant = ctx.tenant if ctx is not None else None
        deadline = time.monotonic() + cfg.offer_timeout_s
        with self.cond:
            while (self._total() >= max(cfg.max_queue, 1)
                   or len(self._queues.get(tenant, ()))
                   >= self._tenant_max(tenant)) and not self._closed:
                remaining = deadline - time.monotonic()
                if not cfg.block_on_full or remaining <= 0:
                    self.rejections[tenant] = \
                        self.rejections.get(tenant, 0) + 1
                    scope = "admission queue" if tenant is None \
                        else f"tenant {tenant!r} queue"
                    raise AdmissionQueueFull(
                        f"{scope} full "
                        f"({len(self._queues.get(tenant, ()))} pending)")
                self.clock.wait(self.cond, remaining)
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queues.setdefault(tenant, []).append(
                _Admitted(key, item, self.clock.monotonic(), chunk=chunk,
                          ctx=ctx))
            self._observe_depth()
            self.cond.notify_all()       # wake the loop to re-plan its wait
        if self.on_admit is not None:
            _fire_hook(self.on_admit, item, ctx)

    def close(self) -> None:
        """Refuse further offers (pending items stay drainable)."""
        with self.cond:
            self._closed = True
            self.cond.notify_all()

    # -- adaptive flush window -----------------------------------------------
    def _observe_depth(self) -> None:
        """EWMA of queue depth; call with ``cond`` held at admission and
        release events (event-driven, so ManualClock tests stay exact)."""
        a = self.config.adaptive_alpha
        total = self._total()
        if total > self.depth_high_water:
            self.depth_high_water = total
        self._depth_ewma += a * (total - self._depth_ewma)

    @property
    def queue_depth_ewma(self) -> float:
        with self.cond:
            return self._depth_ewma

    def effective_latency_budget(self) -> float:
        """The flush window currently in force: the configured constant,
        or — under ``adaptive_latency`` — a linear slide from the min to
        the max budget as the smoothed queue depth approaches one full
        batch (``max_batch_requests``).  Light load short-circuits to
        near-immediate service; a deepening queue buys coalescing time."""
        cfg = self.config
        if not cfg.adaptive_latency:
            return cfg.latency_budget_s
        with self.cond:
            frac = min(1.0, self._depth_ewma
                       / max(cfg.max_batch_requests, 1))
        return cfg.min_latency_budget_s \
            + (cfg.max_latency_budget_s - cfg.min_latency_budget_s) * frac

    # -- consumer side -------------------------------------------------------
    def _due_at(self, a: _Admitted, budget: float) -> float:
        """When ``a`` must flush: its admission time plus the effective
        budget, tightened (never loosened) by its context deadline."""
        if a.ctx is not None and a.ctx.deadline_s is not None:
            budget = min(budget, max(float(a.ctx.deadline_s), 0.0))
        return a.admitted_at + budget

    def next_deadline(self) -> Optional[float]:
        with self.cond:
            if not any(self._queues.values()):
                return None
            budget = self.effective_latency_budget()
            return min(self._due_at(a, budget)
                       for q in self._queues.values() for a in q)

    def _grouped(self, queue: List[_Admitted]) -> Dict[Any, List[_Admitted]]:
        groups: Dict[Any, List[_Admitted]] = {}
        for a in queue:
            groups.setdefault(a.key, []).append(a)
        return groups

    def has_ready(self, now: float) -> bool:
        with self.cond:
            return any(self._ready_reason(g, now) is not None
                       for q in self._queues.values()
                       for g in self._grouped(q).values())

    def _ready_reason(self, group: List[_Admitted],
                      now: float) -> Optional[str]:
        # deadline first: once the oldest request is genuinely due the
        # whole group — sub-cap tail included — must go (the "full" tail
        # hold only applies while nothing has waited out its budget)
        budget = self.effective_latency_budget()
        if now >= min(self._due_at(a, budget) for a in group):
            return "deadline"
        if len(group) >= self.config.max_batch_requests:
            return "full"
        return None

    def pop_ready(self, now: Optional[float] = None,
                  force: bool = False) -> List[ReadyGroup]:
        """Atomically remove and return every group that is due at ``now``
        (every group, reason ``"drain"``, when ``force``).  Groups larger
        than ``max_batch_requests`` release as multiple capped chunks:
        the cap bounds *execution* batch size, not just flush timing — a
        burst that piled up behind one slow execution must not stack into
        a single giant padded batch.

        **Tail policy**: a ``"full"``-triggered release only pops whole
        cap-sized chunks; the sub-cap tail *stays queued* until its own
        deadline (or until later admissions grow it to a full chunk).
        The tail's requests are the newest — nothing has waited long —
        and flushing them immediately would execute a near-empty padded
        batch exactly when load is high enough that the next burst would
        have coalesced with them.  Deadline and drain releases still take
        the tail along: by then its oldest batch-mate has genuinely
        expired, and a drain must leave nothing behind.

        **Drain order**: with one tenant holding due work the released
        list is in arrival order, exactly the historical behavior.  With
        several, groups interleave by weighted deficit round-robin —
        each pass credits every contending tenant its policy weight and
        releases that many groups — so a tenant flooding the queue still
        only advances in proportion to its weight while compliant
        tenants' groups drain on schedule.  Within one tenant, higher
        ``ctx.priority`` groups order first (stable for equal priority).

        **Compile cap** (``max_tenant_compiles`` + the ``is_cold`` seam):
        a non-forced pass releases at most that many *cold* groups per
        tenant; further cold groups stay queued (already past due, so the
        next pass reconsiders them — by which time earlier compiles have
        warmed their keys).  Warm groups always release, and at least one
        due group per tenant always releases, so the loop never spins on
        a fully-deferred queue."""
        if now is None:
            now = self.clock.monotonic()
        cap = max(self.config.max_batch_requests, 1)
        cold_cap = 0 if force else max(int(self.config.max_tenant_compiles),
                                       0)
        per_tenant: Dict[Optional[str], List[ReadyGroup]] = {}
        any_popped = False
        deferred = 0
        with self.cond:
            for tenant, queue in self._queues.items():
                popped_ids = set()
                groups: List[ReadyGroup] = []
                cold_released = 0
                for key, group in self._grouped(queue).items():
                    reason = "drain" if force \
                        else self._ready_reason(group, now)
                    if reason is None:
                        continue
                    if cold_cap > 0 and self.is_cold is not None:
                        try:
                            cold = bool(self.is_cold(key))
                        except Exception:    # defensive: treat as warm
                            cold = False
                        if cold:
                            if cold_released >= cold_cap:
                                deferred += 1
                                continue     # stays queued, due next pass
                            cold_released += 1
                    # a group is homogeneous in chunkability (same key)
                    release = group
                    if reason == "full" and group[0].chunk:
                        release = group[:(len(group) // cap) * cap]
                    step = cap if group[0].chunk else len(release)
                    for lo in range(0, len(release), step):
                        chunk = release[lo:lo + step]
                        groups.append(ReadyGroup(
                            key=key, items=[a.item for a in chunk],
                            reason=reason,
                            admitted_at=tuple(a.admitted_at
                                              for a in chunk),
                            ctx=chunk[0].ctx))
                    popped_ids.update(id(a) for a in release)
                if groups:
                    # survivors keep their admission order
                    self._queues[tenant] = [a for a in queue
                                            if id(a) not in popped_ids]
                    groups.sort(key=lambda g: -(g.ctx.priority
                                                if g.ctx else 0))
                    per_tenant[tenant] = groups
                    any_popped = True
            self.compile_deferrals += deferred
            if any_popped:
                self._observe_depth()
                self.cond.notify_all()   # space freed: unblock producers
        ready = self._drr_order(per_tenant)
        if self.on_flush is not None:
            for g in ready:
                _fire_hook(self.on_flush, g.key, g.items, g.reason, g.ctx)
        return ready

    def _drr_order(self, per_tenant: Dict[Optional[str], List[ReadyGroup]]
                   ) -> List[ReadyGroup]:
        """Interleave per-tenant due-group lists by weighted deficit
        round-robin.  One contending tenant (the whole single-tenant API)
        short-circuits to its own arrival-ordered list."""
        per_tenant = {t: gs for t, gs in per_tenant.items() if gs}
        if len(per_tenant) <= 1:
            return next(iter(per_tenant.values()), [])
        # deterministic tenant cycle: default queue first, then by name
        cycle = sorted(per_tenant, key=lambda t: (t is not None, t or ""))
        # normalize so the heaviest tenant earns one group per pass and a
        # near-zero weight still makes progress (bounded pass count)
        weights = {t: self._tenant_weight(t) for t in cycle}
        top = max(weights.values())
        credit = {t: max(w / top, 1e-3) for t, w in weights.items()}
        deficit = {t: 0.0 for t in cycle}
        cursors = {t: 0 for t in cycle}
        ready: List[ReadyGroup] = []
        remaining = sum(len(gs) for gs in per_tenant.values())
        while remaining:
            for t in cycle:
                groups = per_tenant[t]
                if cursors[t] >= len(groups):
                    continue
                deficit[t] += credit[t]
                while deficit[t] >= 1.0 and cursors[t] < len(groups):
                    ready.append(groups[cursors[t]])
                    cursors[t] += 1
                    deficit[t] -= 1.0
                    remaining -= 1
        return ready

    def drain(self) -> List[ReadyGroup]:
        """Pop everything regardless of deadlines (explicit ``flush()``)."""
        return self.pop_ready(force=True)


# ---------------------------------------------------------------------------
# Background loop.
# ---------------------------------------------------------------------------

class AdmissionLoop:
    """Daemon thread that sleeps until the oldest pending request's
    deadline (waking early on new admissions, which may complete a full
    group) and serves due groups via the injected callback.  On ``stop()``
    it drains the queue before exiting, so no admitted ticket is lost."""

    def __init__(self, batcher: Batcher,
                 serve: Callable[[ReadyGroup], None],
                 name: str = "prediction-admission",
                 on_error: Optional[Callable[[ReadyGroup, BaseException],
                                             None]] = None):
        self.batcher = batcher
        self.clock = batcher.clock
        self._serve = serve
        self._on_error = on_error
        self._stop = threading.Event()
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)

    def start(self) -> "AdmissionLoop":
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def stop(self, join_timeout: float = 30.0) -> None:
        self._stop.set()
        with self.batcher.cond:
            self.batcher.cond.notify_all()
        # may be called from a GC finalizer, which can run on any thread —
        # including this loop's own (joining oneself raises)
        if self._thread.is_alive() \
                and threading.current_thread() is not self._thread:
            self._thread.join(join_timeout)

    def _run(self) -> None:
        batcher, clock = self.batcher, self.clock
        while not self._stop.is_set():
            with batcher.cond:
                if self._stop.is_set():
                    break
                deadline = batcher.next_deadline()
                if deadline is None:               # queue empty: block until
                    batcher.cond.wait()            # offer()/stop() notify
                    continue
                now = clock.monotonic()
                if deadline > now and not batcher.has_ready(now):
                    clock.wait(batcher.cond, deadline - now)
            for group in batcher.pop_ready(clock.monotonic()):
                self._serve_safely(group)
        for group in batcher.drain():                  # drain on stop
            self._serve_safely(group)

    def _serve_safely(self, group: ReadyGroup) -> None:
        """The serve callback fails individual tickets itself; anything
        escaping it is a harness bug — record it, hand the group to
        ``on_error`` so its callers are failed rather than stranded in
        ``result()`` forever, and keep the loop alive rather than leaving
        every future request behind a dead thread."""
        try:
            self._serve(group)
        except BaseException as err:
            self.last_error = err
            if self._on_error is not None:
                try:
                    self._on_error(group, err)
                except Exception:       # pragma: no cover - defensive
                    pass
