"""In-DB model store: versioned, transactional, audited (paper §1/§2).

The paper's motivation is governance: models live *in* the database so they
inherit transactions, versioning, auditing and high availability.  This module
provides those semantics for the torch engine:

- **versioning**: every ``register`` creates an immutable new version;
- **transactionality**: ``transaction()`` stages registrations and either
  commits all or none (a model swap is atomic w.r.t. concurrent readers —
  readers hold a snapshot dict);
- **auditing**: every read/write appends to an audit log;
- **statistics**: per-table column stats (min/max/distinct) power the
  data-property-driven pruning of §4.1 ("derive predicates from data
  statistics").

It doubles as the *catalog* consumed by the SQL frontend, the cross-optimizer
and codegen.  It also fixes the device a deployment runs on: tables and
(through ``compile_plan``) model constants live on the store's ``device``,
which is the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..ml.pipeline import Pipeline
from ..relational.table import Table, resolve_device, to_numpy

__all__ = ["ColumnStats", "ModelStore", "AuditRecord", "content_fingerprint"]


# ---------------------------------------------------------------------------
# Content fingerprinting (plan-signature support).
#
# A model reference inside a cached query plan must be identified by *what the
# model computes*, not by Python object identity: two registrations of
# byte-identical pipelines should share one compiled executable, and
# re-registering a retrained model must miss the cache.  ``content_fingerprint``
# reduces an arbitrary model/featurizer/attr object to a stable canonical form
# (arrays by byte digest, objects by their field contents) and hashes it.
# ---------------------------------------------------------------------------

_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")

# Append-lineage entries kept per table (version, rows): old enough
# versions fall off the chain and lose their prefix-reuse proof, which is
# safe — the serving layer then recomputes whole-table.
_MAX_LINEAGE = 16

# Identity-keyed memo for the (expensive) object branch of _canon_value:
# walking a fitted model hashes every weight array, and the serving layer
# computes a plan signature per request.  Registered artifacts are immutable
# by store contract (every register is a new version), so caching by object
# identity is sound; a weakref finalizer evicts entries on GC before their
# id can be reused.  In-place mutation of an already-fingerprinted object is
# the one unsupported pattern (the stale digest would mask the change).
_CANON_MEMO: Dict[int, Tuple[Any, Any]] = {}


def _canon_object(obj: Any, seen: set) -> Any:
    key = id(obj)
    entry = _CANON_MEMO.get(key)
    if entry is not None and entry[0]() is obj:
        return entry[1]
    # Only memoize traversal roots (seen holds just this object): an interior
    # object's form can be truncated by a cycle marker relative to *this*
    # root, and caching that form would collide objects whose cyclic partners
    # differ.  Roots are what the signature path hits repeatedly anyway
    # (plan attrs like the model object).
    memoizable = len(seen) == 1
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        result = (type(obj).__name__, tuple(
            (f.name, _canon_value(getattr(obj, f.name), seen))
            for f in dataclasses.fields(obj)))
    elif hasattr(obj, "__dict__"):
        # Underscored attrs are fitted state too (e.g. Bucketizer._kept
        # changes the feature layout) — only dunders are infrastructure.
        result = (type(obj).__name__, tuple(
            (k, _canon_value(v, seen))
            for k, v in sorted(vars(obj).items())
            if not k.startswith("__")))
    else:
        return ("repr", _ADDR_RE.sub("", repr(obj)))
    if memoizable:
        try:
            _CANON_MEMO[key] = (
                weakref.ref(obj, lambda _, k=key: _CANON_MEMO.pop(k, None)),
                result)
        except TypeError:
            pass
    return result


def _canon_global(value: Any, seen: set) -> Any:
    """Shallow canon for a callable's resolved globals — never walks whole
    modules or deep library objects (``np`` in a UDF would otherwise pull
    an entire package namespace into every fingerprint)."""
    import types
    if isinstance(value, types.ModuleType):
        return ("module", value.__name__)
    if callable(value) and hasattr(value, "__code__"):
        return ("callable-ref",
                getattr(value, "__qualname__", value.__name__),
                _canon_code(value.__code__, seen))
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return _canon_value(value, seen)
    if hasattr(value, "dtype") and hasattr(value, "shape") \
            and hasattr(value, "__array__"):
        return _canon_value(value, seen)
    return ("repr", _ADDR_RE.sub("", repr(value)))


def _canon_code(code: Any, seen: set) -> Any:
    """Canon of a code object, recursing into nested code objects in
    co_consts (a nested lambda's constants live in *its* consts, not the
    outer function's)."""
    consts = tuple(
        _canon_code(c, seen) if hasattr(c, "co_code")
        else _canon_value(c, seen)
        for c in code.co_consts)
    return ("code", hashlib.sha256(code.co_code).hexdigest(),
            tuple(code.co_names), consts)


def _canon_callable(obj: Any, seen: set) -> Any:
    """Callables hash code + constants + closure + defaults + referenced
    globals: co_code alone cannot tell ``lambda x: x + 1`` from
    ``lambda x: x + 2`` (the constant lives in co_consts), nor
    ``abs(x)`` from ``len(x)`` (the name lives in co_names)."""
    code = obj.__code__
    closure = []
    for cell in (obj.__closure__ or ()):
        try:
            closure.append(_canon_value(cell.cell_contents, seen))
        except ValueError:            # empty cell
            closure.append(("empty-cell",))
    defaults = _canon_value(obj.__defaults__, seen)
    fn_globals = getattr(obj, "__globals__", {}) or {}
    bound_globals = tuple(
        (name, _canon_global(fn_globals[name], seen))
        for name in code.co_names if name in fn_globals)
    return ("callable", getattr(obj, "__qualname__", obj.__name__),
            _canon_code(code, seen), tuple(closure), defaults,
            bound_globals)


def _canon_value(obj: Any, seen: Optional[set] = None) -> Any:
    seen = seen if seen is not None else set()
    if obj is None or isinstance(obj, (bool, int, str, bytes)):
        return obj
    if isinstance(obj, float):
        return ("f", repr(obj))
    if isinstance(obj, np.generic):
        return _canon_value(obj.item(), seen)
    # arrays (numpy, or tensors on any device) by dtype/shape/bytes digest
    if hasattr(obj, "dtype") and hasattr(obj, "shape") \
            and hasattr(obj, "__array__"):
        arr = to_numpy(obj)
        return ("ndarray", str(arr.dtype), tuple(arr.shape),
                hashlib.sha256(np.ascontiguousarray(arr).tobytes())
                .hexdigest())
    if isinstance(obj, (list, tuple)):
        return tuple(_canon_value(v, seen) for v in obj)
    if isinstance(obj, dict):
        return tuple(sorted(
            (str(k), _canon_value(v, seen)) for k, v in obj.items()))
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(repr(_canon_value(v, seen)) for v in obj))
    oid = id(obj)
    if oid in seen:
        return ("cycle", type(obj).__name__)
    seen.add(oid)
    try:
        if callable(obj) and hasattr(obj, "__code__"):
            return _canon_callable(obj, seen)
        return _canon_object(obj, seen)
    finally:
        seen.discard(oid)


def content_fingerprint(obj: Any) -> str:
    """Stable hex digest of an object's *content* (see module note above)."""
    return hashlib.sha256(
        repr(_canon_value(obj)).encode("utf-8")).hexdigest()


@dataclasses.dataclass(frozen=True)
class AuditRecord:
    timestamp: float
    action: str          # register | read | commit | rollback | cluster | append
    subject: str
    version: Optional[int]
    principal: str


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    min: float
    max: float
    n_distinct: int
    distinct_values: Optional[Tuple[float, ...]]   # only if small cardinality


class _Txn:
    def __init__(self, store: "ModelStore"):
        self.store = store
        self.staged: List[Tuple[str, Pipeline]] = []
        self.active = False

    def register(self, name: str, pipeline: Pipeline):
        self.staged.append((name, pipeline))

    def __enter__(self):
        self.active = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            with self.store._lock:
                for name, pipeline in self.staged:
                    self.store._do_register(name, pipeline)
                self.store._audit("commit", f"txn[{len(self.staged)}]", None)
            for name, _ in self.staged:
                self.store._notify_invalidation("model", name)
        else:
            self.store._audit("rollback", f"txn[{len(self.staged)}]", None)
        self.active = False
        return False


class ModelStore:
    """Model + table catalog on one device.

    ``device=None`` means the card (``"cuda"``); without one the store
    raises rather than running on the CPU — pass ``device="cpu"`` for
    that."""

    def __init__(self, principal: str = "system", device: Any = None):
        self.device = resolve_device(device)
        self._models: Dict[str, List[Pipeline]] = {}
        self._tables: Dict[str, Table] = {}
        self._partitioned: Dict[str, Any] = {}     # name -> PartitionedTable
        self._table_versions: Dict[str, int] = {}
        # append lineage: name -> ascending (version, rows) pairs; version
        # v's rows are an immutable prefix of any later version in the same
        # chain.  register_table resets the chain (rows replaced wholesale).
        self._lineage: Dict[str, List[Tuple[int, int]]] = {}
        self._stats: Dict[str, Dict[str, ColumnStats]] = {}
        self._clusters: Dict[str, Any] = {}
        self._calibrations: Dict[Any, Any] = {}
        self._digests: Dict[Tuple[str, int], str] = {}
        self._audit_log: List[AuditRecord] = []
        self._invalidation_listeners: List[Any] = []
        self._lock = threading.RLock()
        self.principal = principal

    # -- invalidation hooks ---------------------------------------------------
    def add_invalidation_listener(self, fn) -> "Any":
        """Register ``fn(kind, name)`` to fire after every ``register_model``
        (kind='model'), ``register_table`` (kind='table'), or stats-stable
        ``append_rows`` (kind='append').  Caches keyed by artifact content
        use this to *free* entries that reference the re-registered name —
        content digests already make stale entries unreachable, but without
        eviction they still occupy slots/bytes.  An 'append' is the one
        kind that promises the old rows survive as an immutable prefix, so
        listeners may *keep* warm state and serve deltas instead of
        evicting.  Returns an unsubscriber."""
        self._invalidation_listeners.append(fn)
        return lambda: self._invalidation_listeners.remove(fn)

    def _notify_invalidation(self, kind: str, name: str) -> None:
        # Fired outside self._lock: listeners typically take their own cache
        # locks, and holding the store lock across foreign locks invites
        # lock-order inversions.
        for fn in list(self._invalidation_listeners):
            fn(kind, name)

    # -- measured calibrations ------------------------------------------------
    def get_calibration(self, key) -> Any:
        """Cached measurement (e.g. tree-strategy cost constants) or None.
        Calibrations describe the *hardware*, not any registered artifact, so
        re-registering models/tables never invalidates them."""
        with self._lock:
            return self._calibrations.get(key)

    def put_calibration(self, key, value) -> None:
        with self._lock:
            self._calibrations[key] = value

    # -- audit ----------------------------------------------------------------
    def _audit(self, action: str, subject: str, version: Optional[int]):
        self._audit_log.append(AuditRecord(
            time.time(), action, subject, version, self.principal))

    @property
    def audit_log(self) -> List[AuditRecord]:
        return list(self._audit_log)

    # -- models -----------------------------------------------------------------
    def register_model(self, name: str, pipeline: Pipeline) -> int:
        with self._lock:
            version = self._do_register(name, pipeline)
        self._notify_invalidation("model", name)
        return version

    def _do_register(self, name: str, pipeline: Pipeline) -> int:
        versions = self._models.setdefault(name, [])
        versions.append(pipeline)
        version = len(versions)
        self._audit("register", name, version)
        return version

    def get_model(self, name: str, version: Optional[int] = None) -> Pipeline:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"model {name!r} not found; "
                               f"have {sorted(self._models)}")
            versions = self._models[name]
            v = version or len(versions)
            self._audit("read", name, v)
            return versions[v - 1]

    def model_version(self, name: str) -> int:
        return len(self._models.get(name, []))

    def model_digest(self, name: str, version: Optional[int] = None) -> str:
        """Content digest of a registered pipeline version (memoized —
        registered versions are immutable)."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise KeyError(f"model {name!r} not found")
            v = version or len(versions)
            key = (name, v)
            digest = self._digests.get(key)
            if digest is None:
                digest = content_fingerprint(versions[v - 1])
                self._digests[key] = digest
            return digest

    def transaction(self) -> _Txn:
        return _Txn(self)

    # -- model clustering artifacts (paper §4.1) ---------------------------------
    def register_clustered(self, name: str, artifact: Any):
        with self._lock:
            self._clusters[name] = artifact
            self._audit("cluster", name, None)

    def get_clustered(self, name: str) -> Optional[Any]:
        return self._clusters.get(name)

    # -- tables -----------------------------------------------------------------
    def register_table(self, name: str, table: Table,
                       max_distinct: int = 64,
                       partition_rows: Optional[int] = None,
                       partition_by: Optional[str] = None,
                       partition_bounds: Optional[Any] = None) -> None:
        """Register (a new version of) a table.  ``partition_rows`` turns on
        row-range partitioning: the table is split into contiguous
        partitions of that many rows and a zone map (per-column min/max,
        small-domain bitsets, null count) is collected per partition at
        registration — the statistics the ``partition_pruning`` rule and
        the sharded executor consume.  A :class:`PartitionedTable` may also
        be passed directly (pre-built partitioning).

        ``partition_by`` declares a range-partitioning key (the table must
        be sorted by it): with ``partition_rows`` the row ranges snap to
        key boundaries; with ``partition_bounds`` (explicit split values)
        the ranges follow the bounds exactly, so two tables registered
        with the same bounds are co-partitioned — the precondition the
        ``distributed_plan`` rule checks (``compatible_partitioning``)
        before rewriting their joins partition-wise."""
        from .partition import PartitionedTable
        partitioned: Optional[PartitionedTable] = None
        if isinstance(table, PartitionedTable):
            partitioned = table
            table = partitioned.table
        elif partition_bounds is not None:
            if partition_by is None:
                raise ValueError("partition_bounds requires partition_by")
            partitioned = PartitionedTable.build_by_bounds(
                table, partition_by, partition_bounds,
                max_domain=max_distinct)
        elif partition_rows is not None:
            partitioned = PartitionedTable.build(table, partition_rows,
                                                 max_domain=max_distinct,
                                                 partition_by=partition_by)
        elif partition_by is not None:
            raise ValueError(
                "partition_by requires partition_rows or partition_bounds")
        table = table.to(self.device)
        if partitioned is not None:
            partitioned.table = table
        with self._lock:
            version = self._table_versions.get(name, 0) + 1
            if partitioned is not None:
                # stamp the registration version on the object itself so
                # executors can validate a (table, partitioning) pair
                # without racing separate catalog reads
                partitioned.version = version
                self._partitioned[name] = partitioned
            else:
                # re-registering without partitioning drops stale zone maps
                self._partitioned.pop(name, None)
            self._tables[name] = table
            self._table_versions[name] = version
            self._lineage[name] = [(version, table.capacity)]
            stats: Dict[str, ColumnStats] = {}
            valid = to_numpy(table.valid)
            for cname in table.names:
                arr = to_numpy(table.column(cname))[valid]
                if arr.dtype.kind not in "iuf" or arr.size == 0:
                    continue
                uniq = np.unique(arr)
                stats[cname] = ColumnStats(
                    min=float(arr.min()), max=float(arr.max()),
                    n_distinct=int(uniq.size),
                    distinct_values=tuple(float(v) for v in uniq)
                    if uniq.size <= max_distinct else None)
            self._stats[name] = stats
        self._notify_invalidation("table", name)

    def append_rows(self, name: str, batch: Table,
                    max_distinct: int = 64) -> int:
        """Append ``batch`` to table ``name`` as a first-class ingest step
        (streaming ingest) and return the new table version.

        Unlike ``register_table`` — which replaces the rows wholesale and
        invalidates everything derived from them — an append promises the
        old version's rows are an *immutable prefix* of the new version:

        - the version counter still bumps (so exact result-cache keys go
          stale and nothing serves old-version answers as current), but
          :meth:`version_lineage` records the ``(version, rows)`` chain so
          caches can prove prefix reuse and recompute only the delta;
        - a partitioned table keeps every existing partition object and
          zone map untouched; fresh zone maps are collected only over the
          appended row range (``PartitionedTable.append``);
        - column stats merge conservatively (min/max extend, small distinct
          sets union exactly; a too-large cardinality keeps the prefix
          count as a lower bound).  When the merged stats equal the old
          ones — an *in-domain* batch — listeners get ``kind='append'``:
          the signal that every plan-level fact survives and only result
          freshness moved.  Otherwise a full ``kind='table'`` invalidation
          fires, because stats-derived plan facts may not hold for the
          appended rows."""
        with self._lock:
            if name not in self._tables:
                raise KeyError(f"table {name!r} not registered; "
                               f"have {sorted(self._tables)}")
            current = self._table_versions[name]
            if batch.capacity == 0:
                self._audit("append", name, current)
                return current
            base = self._tables[name]
            batch = batch.to(self.device)
            combined = base.concat_rows(batch)
            version = current + 1
            old_pt = self._partitioned.get(name)
            if old_pt is not None:
                new_pt = old_pt.append(batch, combined,
                                       max_domain=max_distinct)
                new_pt.version = version
                self._partitioned[name] = new_pt
            self._tables[name] = combined
            self._table_versions[name] = version
            lineage = self._lineage.setdefault(
                name, [(current, base.capacity)])
            lineage.append((version, combined.capacity))
            del lineage[:-_MAX_LINEAGE]
            old_stats = self._stats.get(name, {})
            merged = self._merge_stats(old_stats, batch, max_distinct)
            stats_changed = merged != old_stats
            if stats_changed:
                self._stats[name] = merged
            self._audit("append", name, version)
        self._notify_invalidation(
            "table" if stats_changed else "append", name)
        return version

    @staticmethod
    def _merge_stats(old: Dict[str, ColumnStats], batch: Table,
                     max_distinct: int) -> Dict[str, ColumnStats]:
        """Column stats for prefix+batch without rescanning the prefix."""
        stats = dict(old)
        valid = to_numpy(batch.valid)
        for cname in batch.names:
            arr = to_numpy(batch.column(cname))[valid]
            if arr.dtype.kind not in "iuf" or arr.size == 0:
                continue
            lo, hi = float(arr.min()), float(arr.max())
            prev = stats.get(cname)
            if prev is None:
                uniq = np.unique(arr)
                stats[cname] = ColumnStats(
                    min=lo, max=hi, n_distinct=int(uniq.size),
                    distinct_values=tuple(float(v) for v in uniq)
                    if uniq.size <= max_distinct else None)
                continue
            if prev.distinct_values is not None:
                union = sorted(set(prev.distinct_values)
                               | {float(v) for v in np.unique(arr)})
                n_distinct = len(union)
                distinct = tuple(union) if len(union) <= max_distinct \
                    else None
            else:
                # the prefix cardinality is a valid lower bound; keeping it
                # (rather than guessing) also keeps the stats fingerprint
                # stable, which is what lets warm plans survive the append
                n_distinct = prev.n_distinct
                distinct = None
            stats[cname] = ColumnStats(
                min=min(prev.min, lo), max=max(prev.max, hi),
                n_distinct=n_distinct, distinct_values=distinct)
        return stats

    def version_lineage(self, name: str) -> Tuple[Tuple[int, int], ...]:
        """Append lineage of a table: ascending ``(version, rows)`` pairs
        ending at the current version.  Version ``v``'s rows are an
        immutable, bit-identical prefix of any later version in the same
        chain — the proof the serving layer needs to splice a cached
        old-version result with delta-only compute.  ``register_table``
        resets the chain (no prefix relationship across re-registrations);
        the chain is bounded, so very old versions simply fall off and
        their cached results take the whole-table fallback."""
        with self._lock:
            lineage = self._lineage.get(name)
            if lineage:
                return tuple(lineage)
            v = self._table_versions.get(name, 0)
            table = self._tables.get(name)
            return ((v, table.capacity),) if table is not None and v else ()

    def table_version(self, name: str) -> int:
        """Monotone per-name registration counter.  Materialized-result
        caches key on it: a sub-plan's *signature* identifies what the plan
        computes, the table version identifies the data it read."""
        return self._table_versions.get(name, 0)

    def get_partitioned(self, name: str):
        """The :class:`~repro_torch.core.partition.PartitionedTable` registered
        under ``name``, or ``None`` when the table is unpartitioned."""
        return self._partitioned.get(name)

    def get_table(self, name: str) -> Table:
        if name not in self._tables:
            raise KeyError(f"table {name!r} not registered; "
                           f"have {sorted(self._tables)}")
        return self._tables[name]

    def table_names(self) -> List[str]:
        return sorted(self._tables)

    def get_stats(self, table: str) -> Dict[str, ColumnStats]:
        return self._stats.get(table, {})
