"""Request context and tenant policy for the multi-tenant front door.

One shared engine, isolation by policy (paper §1's "millions of users"
deployment): every request entering :class:`PredictionService` carries a
:class:`RequestContext` naming its tenant, session, priority and deadline.
The context survives every hop — submit -> admission queue -> drain order ->
batched execution -> stats ledger — so that

- the admission layer can keep per-tenant queues with weighted
  deficit-round-robin drain and per-tenant backpressure,
- the result cache can charge entries against per-tenant quotas,
- ``tenant_info()`` can attribute latency/coalescing/eviction per tenant,

while ``tenant=None`` (the default, and the only pre-existing path) flows
through a dedicated default queue with byte-for-byte the old behavior.

Compiled *executables* are deliberately **not** tenant-scoped: the same plan
signature compiles once and serves every tenant — cross-tenant sharing of
compilation is the economic point of multi-tenancy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["RequestContext", "TenantPolicy", "Session"]


@dataclasses.dataclass(frozen=True)
class RequestContext:
    """Identity + QoS envelope of one request.

    ``deadline_s`` is a *relative* admission deadline (seconds the request
    may wait in queue before it must flush); the effective deadline is
    ``min(service latency budget, deadline_s)``, so a context can only
    tighten, never loosen, the service's budget.  ``priority`` breaks
    drain-order ties between groups of the same tenant (higher first).

    ``trace`` carries the request's telemetry span tree
    (:class:`~repro_torch.serve.telemetry.Trace`).  It is per-*request*, not
    per-session: ``submit()`` stamps it onto a private copy of the caller's
    context (a :class:`Session`'s ctx is shared across concurrent calls),
    and it never participates in equality/grouping — two requests with
    different traces still coalesce.
    """

    tenant: Optional[str] = None
    session: Optional[str] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    #: Freshness SLA under streaming ingest: a non-None budget says "an
    #: answer computed over a snapshot at most this many seconds old is
    #: acceptable".  When the only thing that changed since a cached result
    #: was produced is an *append* within the budget, the service may serve
    #: the pre-append snapshot instead of touching the delta rows at all.
    #: ``None`` (default) always demands the current version.  Participates
    #: in equality on purpose: requests with different freshness demands
    #: must not coalesce into one answer.
    max_staleness_s: Optional[float] = None
    trace: Optional[Any] = dataclasses.field(default=None, compare=False,
                                             repr=False)


#: Context every bare (ctx-less) submit runs under — the single-tenant path.
DEFAULT_CONTEXT = RequestContext()


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant isolation knobs, registered with the service.

    ``weight`` scales the tenant's share of the deficit-round-robin drain
    (2.0 drains twice as often as 1.0 under contention).  ``max_queue``
    caps the tenant's *own* admission queue (None = the service-wide
    default); a full tenant queue rejects/blocks only that tenant.
    ``result_cache_bytes``/``result_cache_entries`` cap the tenant's
    share of the materialized-result cache (0 = unlimited); an over-quota
    insert evicts the tenant's own lowest-weight entries, never a
    neighbor's.
    """

    weight: float = 1.0
    max_queue: Optional[int] = None
    result_cache_bytes: int = 0
    result_cache_entries: int = 0
    #: Tenant-wide freshness SLA default (see
    #: ``RequestContext.max_staleness_s``); a request-level value wins.
    max_staleness_s: Optional[float] = None


class Session:
    """Long-lived front-door handle binding a context to a service.

    Thin by design: all state (caches, queues, stats) lives in the service;
    a session only pins the :class:`RequestContext` stamped on every call,
    so handles are free to create and need no teardown.
    """

    _COUNTER = [0]

    def __init__(self, service, tenant: Optional[str] = None,
                 session_id: Optional[str] = None, priority: int = 0,
                 deadline_s: Optional[float] = None,
                 max_staleness_s: Optional[float] = None):
        if session_id is None:
            Session._COUNTER[0] += 1
            session_id = f"session-{Session._COUNTER[0]}"
        self.service = service
        self.ctx = RequestContext(tenant=tenant, session=session_id,
                                  priority=priority, deadline_s=deadline_s,
                                  max_staleness_s=max_staleness_s)

    @property
    def tenant(self) -> Optional[str]:
        return self.ctx.tenant

    def sql(self, query: str, params: Any = None, **kw):
        """Parse + serve SQL text synchronously (see ``PredictionService
        .sql``)."""
        return self.service.sql(query, params=params, ctx=self.ctx, **kw)

    def submit(self, plan, params: Any = None, **kw):
        """Asynchronous admission under this session's context; returns the
        service's :class:`PredictionTicket`."""
        return self.service.submit(plan, params=params, ctx=self.ctx, **kw)

    def predict(self, plan, **kw):
        """Synchronous single-request serve under this session's context."""
        return self.service.predict(plan, ctx=self.ctx, **kw)

    def __repr__(self):
        return (f"Session(tenant={self.ctx.tenant!r}, "
                f"id={self.ctx.session!r})")
