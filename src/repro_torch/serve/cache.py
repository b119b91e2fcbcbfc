"""Cost-aware cache eviction, shared by the serving layer's two caches.

Plain LRU is the wrong policy for a serving cache whose entries differ by
orders of magnitude in replacement cost: evicting a compiled executable that
took 800 ms of optimizer + codegen time to build because three 2 ms lookups
arrived after it is a bad trade, and a materialized sub-plan result that
saves a full model-inference pass is worth more slots than a cheap
projection.  :class:`CostAwareCache` therefore ranks eviction victims by

    weight = observed cost (compile or execution seconds) x hit count

and evicts the lowest-weight entry first (ties broken by recency, i.e. LRU
among equals).  Capacity is bounded two ways:

- ``max_entries`` — slot budget (0 disables caching entirely, preserving
  the historical ``max_cache_entries=0`` contract);
- ``max_bytes`` — bytes budget measured from the cached values' array
  sizes (``value_nbytes``); enforced after *every* insert, including
  against the entry just inserted (an entry larger than the whole budget
  is never retained).

Entries carry *tags* (e.g. ``("model", "los")`` for every model a plan
references, ``("table", "patient_info")`` for every scan) so that
``ModelStore`` invalidation hooks can evict exactly the entries referencing
a re-registered artifact — content digests already make stale entries
unreachable, but without eviction they would keep occupying budget.

**Tenant quotas** (multi-tenant front door): entries optionally carry the
``tenant`` that produced them, and ``set_tenant_quota`` bounds one tenant's
share of the cache (entries and/or bytes).  Quota enforcement is *local*:
an over-quota insert evicts the lowest-weight entries of **that tenant
only**, so a flooding tenant churns its own slice while its neighbors'
entries stay resident (they can still be displaced by the global budget,
which ranks all tenants' entries together — the global bound is a property
of the machine, not of fairness).  Untenanted entries (``tenant=None``)
are only ever subject to the global budgets, preserving the pre-tenant
behavior byte for byte.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["CostAwareCache", "CacheEntry", "value_nbytes"]


def value_nbytes(value: Any) -> int:
    """Bytes held by the array payload of a cached value.

    Understands tables (columns + validity mask), arrays (anything with
    ``nbytes``: a ``torch.Tensor`` counts the bytes it holds on its
    device), and containers thereof; objects without array payload count 0
    (a compiled closure's footprint is its staged device constants, which
    this walk cannot see — callers pass an explicit estimate for those).
    """
    if value is None:
        return 0
    if hasattr(value, "columns") and hasattr(value, "valid"):   # Table
        return sum(value_nbytes(v) for v in value.columns.values()) \
            + value_nbytes(value.valid)
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    if isinstance(value, dict):
        return sum(value_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(value_nbytes(v) for v in value)
    return 0


@dataclasses.dataclass
class CacheEntry:
    key: Any
    value: Any
    cost_s: float            # observed compile or execution seconds
    nbytes: int
    tags: Tuple[Any, ...]
    hits: int = 0
    seq: int = 0             # recency stamp (monotone)
    tenant: Optional[str] = None   # quota ledger owner (None: global only)

    @property
    def weight(self) -> float:
        # Never-hit entries rank by cost alone (a fresh expensive compile
        # must not be the designated victim of the next insert).
        return max(self.cost_s, 1e-9) * max(self.hits, 1)


class CostAwareCache:
    """Dict-like cache with cost x hit-count weighted eviction under slot
    and bytes budgets.  Thread-safe; all operations are O(n) worst case in
    the (small) entry count."""

    def __init__(self, max_entries: int = 64, max_bytes: int = 0):
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)          # 0 = unbounded bytes
        self._entries: Dict[Any, CacheEntry] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_in_use = 0
        # tenant -> (max_entries, max_bytes); 0 = unbounded on that axis
        self._tenant_quotas: Dict[str, Tuple[int, int]] = {}
        self.tenant_evictions: Dict[str, int] = {}

    # -- tenant quotas --------------------------------------------------------
    def set_tenant_quota(self, tenant: str, max_entries: int = 0,
                         max_bytes: int = 0) -> None:
        """Bound ``tenant``'s share of the cache (0 = unbounded on that
        axis).  Applies to future inserts; a tightened quota is enforced
        on the tenant's next ``put``."""
        with self._lock:
            self._tenant_quotas[tenant] = (int(max_entries), int(max_bytes))

    def tenant_usage(self, tenant: Optional[str] = None) -> Dict[str, int]:
        """Resident entries/bytes plus quota-eviction count for one
        tenant's slice of the cache."""
        with self._lock:
            mine = [e for e in self._entries.values() if e.tenant == tenant]
            return {"entries": len(mine),
                    "bytes": sum(e.nbytes for e in mine),
                    "evictions": self.tenant_evictions.get(tenant, 0)}

    # -- lookup ---------------------------------------------------------------
    def get(self, key: Any, count: bool = True) -> Optional[Any]:
        """Lookup with recency/eviction-weight bump.  ``count=False`` keeps
        the lookup out of the cache's ``hits``/``misses`` ledger: the
        serving layer uses it for *shape-bucket* executable lookups, whose
        hit rate is a different signal (bucket reuse) than signature hit
        rate (query reuse) — folding both into one pair of counters is
        exactly the stats conflation the service's split
        ``bucket_hits``/``bucket_compiles`` counters exist to avoid.  The
        entry's own ``hits`` (eviction weight) still bumps either way."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                if count:
                    self.misses += 1
                return None
            if count:
                self.hits += 1
            e.hits += 1
            self._seq += 1
            e.seq = self._seq
            return e.value

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[Any]:
        with self._lock:
            return list(self._entries)

    def entry(self, key: Any) -> Optional[CacheEntry]:
        """Introspection (no hit/recency bump)."""
        with self._lock:
            return self._entries.get(key)

    # -- insert / evict -------------------------------------------------------
    def put(self, key: Any, value: Any, cost_s: float = 0.0,
            nbytes: Optional[int] = None,
            tags: Iterable[Any] = (),
            tenant: Optional[str] = None) -> List[Any]:
        """Insert (or refresh) ``key``; returns the keys evicted to make
        room.  Re-putting an existing key keeps its hit count.

        Bytes-ledger contract (regression-tested): an overwrite *replaces*
        the key's byte charge — the old entry's bytes are released before
        the new charge lands, so refreshing a resident key never
        double-counts against ``max_bytes`` (which would spuriously evict
        on a no-op re-put).

        ``tenant`` charges the entry against that tenant's quota (see
        ``set_tenant_quota``); over-quota inserts evict the tenant's own
        lowest-weight entries before the global budgets run."""
        nbytes = value_nbytes(value) if nbytes is None else int(nbytes)
        with self._lock:
            self._seq += 1
            old = self._entries.get(key)
            if old is not None:
                self.bytes_in_use -= old.nbytes
                # Latest non-zero measurement wins: an early cost observed
                # at coarser granularity (e.g. whole-query time standing in
                # for a subtree) is corrected by a later, tighter one.
                entry = dataclasses.replace(
                    old, value=value,
                    cost_s=cost_s if cost_s > 0 else old.cost_s,
                    nbytes=nbytes, tags=tuple(tags) or old.tags,
                    seq=self._seq,
                    tenant=tenant if tenant is not None else old.tenant)
            else:
                entry = CacheEntry(key=key, value=value, cost_s=cost_s,
                                   nbytes=nbytes, tags=tuple(tags),
                                   seq=self._seq, tenant=tenant)
            self._entries[key] = entry
            self.bytes_in_use += nbytes
            evicted = self._enforce_tenant_quota(entry.tenant)
            return evicted + self._enforce_budgets()

    def _enforce_tenant_quota(self, tenant: Optional[str]) -> List[Any]:
        """Evict ``tenant``'s own lowest-weight entries until its slice fits
        its quota.  Only that tenant's entries are candidates — quota
        pressure never touches a neighbor."""
        if tenant is None:
            return []
        quota = self._tenant_quotas.get(tenant)
        if quota is None:
            return []
        q_entries, q_bytes = quota
        evicted: List[Any] = []
        while True:
            mine = [e for e in self._entries.values() if e.tenant == tenant]
            if not mine:
                break
            over = (q_entries and len(mine) > q_entries) \
                or (q_bytes and sum(e.nbytes for e in mine) > q_bytes)
            if not over:
                break
            victim = min(mine, key=lambda e: (e.weight, e.seq))
            self._remove(victim.key)
            evicted.append(victim.key)
            self.evictions += 1
            self.tenant_evictions[tenant] = \
                self.tenant_evictions.get(tenant, 0) + 1
        return evicted

    def _enforce_budgets(self) -> List[Any]:
        evicted: List[Any] = []
        while self._entries and (
                len(self._entries) > max(self.max_entries, 0)
                or (self.max_bytes and self.bytes_in_use > self.max_bytes)):
            victim = min(self._entries.values(),
                         key=lambda e: (e.weight, e.seq))
            self._remove(victim.key)
            evicted.append(victim.key)
            self.evictions += 1
            if victim.tenant is not None:
                self.tenant_evictions[victim.tenant] = \
                    self.tenant_evictions.get(victim.tenant, 0) + 1
        return evicted

    def _remove(self, key: Any) -> None:
        e = self._entries.pop(key)
        self.bytes_in_use -= e.nbytes

    def pop(self, key: Any) -> Optional[CacheEntry]:
        """Remove one entry (refunding its byte charge) and return it, or
        ``None`` if absent.  Not an eviction in the stats sense: the caller
        is *superseding* the entry — the streaming-ingest path uses this to
        retire a prefix result the moment its spliced successor (covering
        strictly more rows of the same lineage) has been stored, so the two
        never double-charge the bytes budget."""
        with self._lock:
            if key not in self._entries:
                return None
            entry = self._entries[key]
            self._remove(key)
            return entry

    def evict_if(self, pred: Callable[[CacheEntry], bool]) -> List[Any]:
        """Evict every entry matching ``pred``; returns evicted keys."""
        with self._lock:
            victims = [k for k, e in self._entries.items() if pred(e)]
            for k in victims:
                self._remove(k)
            self.evictions += len(victims)
            return victims

    def evict_by_tag(self, tag: Any) -> List[Any]:
        """Evict exactly the entries carrying ``tag`` (invalidation hook
        target: tag = ('model', name) on ``register_model``)."""
        return self.evict_if(lambda e: tag in e.tags)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes_in_use = 0

    def info(self) -> Dict[str, Any]:
        with self._lock:
            out = {"entries": len(self._entries),
                   "bytes": self.bytes_in_use,
                   "hits": self.hits, "misses": self.misses,
                   "evictions": self.evictions}
            if self._tenant_quotas or any(e.tenant is not None
                                          for e in self._entries.values()):
                by_tenant: Dict[str, Dict[str, int]] = {}
                for e in self._entries.values():
                    if e.tenant is None:
                        continue
                    d = by_tenant.setdefault(e.tenant,
                                             {"entries": 0, "bytes": 0})
                    d["entries"] += 1
                    d["bytes"] += e.nbytes
                out["tenants"] = by_tenant
            return out
