"""Partitioned tables with per-partition zone maps (classic DB partition
pruning, applied to prediction queries).

A :class:`PartitionedTable` wraps one :class:`~repro_torch.relational.table.Table`
with contiguous row-range partitions.  At registration time
(``ModelStore.register_table(..., partition_rows=...)``) every partition
gets a **zone map**: per-column min/max over its *valid* rows, a small
categorical/integer domain bitset when the partition's distinct-value count
is low, and the partition's null count (in this engine a NULL is an invalid
*row* — the validity mask — so the null count is per-partition rather than
per-column).

Zone maps power the ``partition_pruning`` optimizer rule: a conjunctive
WHERE predicate whose single-column constraints provably exclude every
valid row of a partition lets the plan skip that partition *statically* —
the same data-skipping trick every columnar warehouse plays, here feeding
the sharded SPMD executor (``serve/sharded.py``) which only places
surviving partitions on devices.

**Range partitioning on a key** (``register_table(..., partition_by=...)``)
additionally records the partitioning column: partitions are still
contiguous row ranges, but boundaries snap to key-value changes so one key
never straddles two partitions (the table must be sorted by the key), or
follow caller-supplied ``partition_bounds`` split points so two tables can
be *co-partitioned*.  :func:`compatible_partitioning` is the check the
``distributed_plan`` rule runs before rewriting a join into per-partition
local joins: both sides declare the join column as their partitioning key,
have equal partition counts, and — verified from the zone maps themselves,
not trusted metadata — no valid key range of partition ``i`` on one side
intersects a differently-indexed partition's range on the other.  Under
that condition a row in left partition ``i`` can only match inside right
partition ``i``, so the join distributes over aligned partition pairs.

Soundness contract (property-tested in
``tests/test_partitioned_execution.py``): :meth:`ZoneMap.may_match` may
return ``True`` for a partition with no matching row (zone maps are
conservative) but must never return ``False`` for a partition containing a
valid row that satisfies the constraint.  Selections only ever *narrow*
the validity mask, so dropping a partition whose valid rows all fail the
filter chain — or one with no valid rows at all — cannot change any
downstream result over valid rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..relational.expr import Constraint
from ..relational.table import Table, to_numpy

__all__ = ["ColumnZone", "ZoneMap", "Partition", "PartitionedTable",
           "compatible_partitioning"]


# Domain bitsets above this cardinality are dropped (min/max still held);
# matches ModelStore's ``max_distinct`` default for column stats.
_MAX_DOMAIN = 64


@dataclasses.dataclass(frozen=True)
class ColumnZone:
    """Zone-map entry for one column of one partition.

    ``min``/``max`` are over the partition's *valid* rows (``None`` when
    the partition has no valid rows).  ``domain`` is the exact set of
    distinct valid values when small (categorical codes, low-cardinality
    ints) — it makes equality/inequality pruning exact instead of
    range-approximate.  ``kind`` is the column's numpy dtype kind: zone
    tests must compare in the dtype the *runtime filter* compares in
    (see :meth:`ZoneMap.may_match`)."""

    min: Optional[float]
    max: Optional[float]
    domain: Optional[FrozenSet[float]] = None
    kind: str = "f"


@dataclasses.dataclass(frozen=True)
class ZoneMap:
    """Per-partition statistics consulted by the pruning rule."""

    n_rows: int
    null_count: int                      # invalid rows (bag-semantics NULLs)
    columns: Dict[str, ColumnZone]

    @property
    def n_valid(self) -> int:
        return self.n_rows - self.null_count

    def may_match(self, c: Constraint) -> bool:
        """Could any *valid* row of this partition satisfy ``c``?

        Conservative: unknown columns/operators answer ``True``.  An
        all-NULL partition answers ``False`` for every constraint (no
        valid row exists to match)."""
        if self.n_valid == 0:
            return False
        zone = self.columns.get(c.column)
        if zone is None or zone.min is None:
            # no zone for the column -> cannot prove absence; conservative
            return True
        try:
            float(c.value)
        except (TypeError, ValueError):
            return True
        # Compare in the dtype the runtime filter compares in.  A float
        # column (or an int32 column promoted against a python float)
        # compares against a literal in float32, so a float64
        # zone test could disagree with the filter on rounding (e.g.
        # float32(0.1) > 0.1) and prune a partition whose rows match.
        # float32 casting is monotone, so cast bounds stay true bounds.
        if zone.kind == "f" or np.asarray(c.value).dtype.kind == "f":
            def cast(x):
                return float(np.float32(x))
        else:                              # int/bool vs int: exact compare
            cast = float
        v = cast(c.value)
        lo, hi = cast(zone.min), cast(zone.max)
        domain = frozenset(cast(d) for d in zone.domain) \
            if zone.domain is not None else None
        if c.kind == "==":
            if domain is not None:
                return v in domain
            return lo <= v <= hi
        if c.kind == "!=":
            if domain is not None:
                return domain != frozenset((v,))
            return not (lo == hi == v)
        if c.kind == "<":
            return lo < v
        if c.kind == "<=":
            return lo <= v
        if c.kind == ">":
            return hi > v
        if c.kind == ">=":
            return hi >= v
        return True

    def may_match_all(self, constraints: Sequence[Constraint]) -> bool:
        """Conjunction: the partition survives only if every constraint
        could individually match (a conjunct that cannot match any valid
        row empties the whole AND)."""
        return all(self.may_match(c) for c in constraints)


@dataclasses.dataclass(frozen=True)
class Partition:
    """One contiguous row range ``[start, stop)`` of the base table."""

    index: int
    start: int
    stop: int
    zone: ZoneMap

    @property
    def n_rows(self) -> int:
        return self.stop - self.start


def _column_zone(arr: np.ndarray, valid: np.ndarray,
                 max_domain: int) -> ColumnZone:
    vals = arr[valid]
    if vals.size == 0:
        return ColumnZone(min=None, max=None, domain=None)
    if arr.dtype.kind == "f" and np.isnan(vals).any():
        # NaN defeats ordered stats (min/max propagate NaN, and a NaN row
        # *satisfies* any != constraint): publish no stats — the partition
        # then survives every constraint, which is the sound direction.
        return ColumnZone(min=None, max=None, domain=None)
    lo = float(vals.min())
    hi = float(vals.max())
    domain: Optional[FrozenSet[float]] = None
    if arr.dtype.kind in "iub":           # exact domains only for discrete
        uniq = np.unique(vals)
        if uniq.size <= max_domain:
            domain = frozenset(float(v) for v in uniq)
    return ColumnZone(min=lo, max=hi, domain=domain, kind=arr.dtype.kind)


class PartitionedTable:
    """A table plus its row-range partitions and their zone maps.

    ``version`` is stamped by ``ModelStore.register_table`` (the table's
    registration counter at the moment this partitioning was installed):
    executors holding a compiled plan compare the *object's own* stamp
    against their compile-time snapshot, which stays race-free however
    catalog reads interleave with a concurrent re-registration.

    ``partition_by`` records the range-partitioning key column when the
    partitioning was built on one (see :meth:`build` /
    :func:`compatible_partitioning`); ``None`` for plain row-count
    partitioning."""

    def __init__(self, table: Table, partitions: Sequence[Partition],
                 partition_by: Optional[str] = None):
        self.table = table
        self.partitions: Tuple[Partition, ...] = tuple(partitions)
        self.partition_by = partition_by
        self.version: int = 0
        self._host_view = None
        if self.partitions:
            stops = [p.stop for p in self.partitions]
            starts = [p.start for p in self.partitions]
            if starts[0] != 0 or stops[-1] != table.capacity or any(
                    a.stop != b.start for a, b in zip(self.partitions,
                                                      self.partitions[1:])):
                raise ValueError("partitions must tile the table exactly")

    @classmethod
    def build(cls, table: Table, partition_rows: int,
              max_domain: int = _MAX_DOMAIN,
              partition_by: Optional[str] = None) -> "PartitionedTable":
        """Partition ``table`` into contiguous ranges of ``partition_rows``
        rows (last one ragged) and collect zone maps host-side.

        With ``partition_by`` the table must be sorted (non-decreasing) on
        that column, and each range's end snaps forward past duplicate key
        values: one key value never straddles a partition boundary — the
        invariant partition-wise joins rely on (a key split across two
        left partitions could have its unique right match in only one of
        them)."""
        if partition_rows <= 0:
            raise ValueError(f"partition_rows must be > 0, "
                             f"got {partition_rows}")
        n = table.capacity
        if partition_by is None:
            ranges = [(s, min(s + partition_rows, n))
                      for s in range(0, n, partition_rows)]
            return cls._from_ranges(table, ranges, max_domain, None)
        keys = cls._sorted_key_column(table, partition_by)
        ranges = []
        start = 0
        while start < n:
            stop = min(start + partition_rows, n)
            while stop < n and keys[stop] == keys[stop - 1]:
                stop += 1                   # snap: keep equal keys together
            ranges.append((start, stop))
            start = stop
        return cls._from_ranges(table, ranges, max_domain, partition_by)

    @classmethod
    def build_by_bounds(cls, table: Table, partition_by: str,
                        bounds: Sequence[Any],
                        max_domain: int = _MAX_DOMAIN) -> "PartitionedTable":
        """Range-partition on explicit split points: partition ``i`` holds
        the rows whose key is in ``[bounds[i-1], bounds[i])`` (first/last
        partitions unbounded below/above).  Registering two sorted tables
        with the *same* bounds co-partitions them by construction — the
        setup the ``distributed_plan`` rule turns into partition-wise
        joins.  Partitions may be empty (a bounds gap with no rows)."""
        keys = cls._sorted_key_column(table, partition_by)
        b = np.asarray(list(bounds))
        if b.ndim != 1 or b.size == 0:
            raise ValueError("partition_bounds must be a non-empty 1-D "
                             "sequence of split values")
        if np.any(b[1:] < b[:-1]):
            raise ValueError("partition_bounds must be sorted ascending")
        stops = np.searchsorted(keys, b, side="left")
        edges = [0] + [int(s) for s in stops] + [table.capacity]
        ranges = [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)]
        return cls._from_ranges(table, ranges, max_domain, partition_by)

    @staticmethod
    def _sorted_key_column(table: Table, partition_by: str) -> np.ndarray:
        keys = to_numpy(table.column(partition_by))
        if keys.ndim != 1 or keys.dtype.kind not in "iufb":
            raise ValueError(f"partition key {partition_by!r} must be a "
                             f"1-D numeric column")
        if np.any(keys[1:] < keys[:-1]):
            raise ValueError(
                f"table is not sorted by partition key {partition_by!r}; "
                f"range partitioning needs non-decreasing keys")
        return keys

    @classmethod
    def _from_ranges(cls, table: Table, ranges: Sequence[Tuple[int, int]],
                     max_domain: int, partition_by: Optional[str]
                     ) -> "PartitionedTable":
        valid = to_numpy(table.valid)
        cols = {name: to_numpy(table.column(name)) for name in table.names}
        parts: List[Partition] = []
        for index, (start, stop) in enumerate(ranges):
            pvalid = valid[start:stop]
            zones = {
                name: _column_zone(arr[start:stop], pvalid, max_domain)
                for name, arr in cols.items()
                if arr.dtype.kind in "iufb"
            }
            parts.append(Partition(
                index=index, start=start, stop=stop,
                zone=ZoneMap(n_rows=stop - start,
                             null_count=int((~pvalid).sum()),
                             columns=zones)))
        return cls(table, parts, partition_by=partition_by)

    def append(self, batch: Table, combined: Table,
               partition_rows: Optional[int] = None,
               max_domain: int = _MAX_DOMAIN) -> "PartitionedTable":
        """Incremental partitioning for an append (streaming ingest).

        Returns a new :class:`PartitionedTable` over ``combined`` (= this
        table's rows followed by ``batch``'s rows, see
        ``Table.concat_rows``) that *reuses* every existing
        :class:`Partition` object — and therefore every existing zone map —
        untouched, collecting fresh zone maps only over the appended row
        range.  Appends never extend the (possibly ragged) last partition:
        the batch always opens a new partition at the old row boundary, so
        pre-existing partitions keep their identity and anything proven
        about them (pruning decisions, cached per-partition partials)
        stays provably valid for the prefix.

        For a key-range-partitioned table the batch must itself be sorted
        on the key and start *strictly after* the last existing key — one
        key value must never straddle a partition boundary (the invariant
        partition-wise joins rely on); violating batches raise, and the
        caller falls back to a full re-registration."""
        old_n = self.table.capacity
        bn = batch.capacity
        if combined.capacity != old_n + bn:
            raise ValueError(
                f"combined table has {combined.capacity} rows, expected "
                f"base {old_n} + batch {bn}")
        if bn == 0:
            out = PartitionedTable(combined, self.partitions,
                                   partition_by=self.partition_by)
            out._host_view = self._host_view
            return out
        if partition_rows is None:
            partition_rows = max((p.n_rows for p in self.partitions),
                                 default=bn)
        if self.partition_by is not None:
            keys = self._sorted_key_column(batch, self.partition_by)
            if old_n:
                last = to_numpy(
                    self.table.column(self.partition_by)[-1])
                if keys[0] <= last:
                    raise ValueError(
                        f"append to a table range-partitioned on "
                        f"{self.partition_by!r} must start strictly after "
                        f"the last existing key ({last}); got {keys[0]}")
            ranges = []
            start = 0
            while start < bn:
                stop = min(start + partition_rows, bn)
                while stop < bn and keys[stop] == keys[stop - 1]:
                    stop += 1               # snap: keep equal keys together
                ranges.append((start, stop))
                start = stop
        else:
            ranges = [(s, min(s + partition_rows, bn))
                      for s in range(0, bn, partition_rows)]
        bvalid = to_numpy(batch.valid)
        bcols = {name: to_numpy(batch.column(name))
                 for name in batch.names}
        parts = list(self.partitions)
        for start, stop in ranges:
            pvalid = bvalid[start:stop]
            zones = {
                name: _column_zone(arr[start:stop], pvalid, max_domain)
                for name, arr in bcols.items()
                if arr.dtype.kind in "iufb"
            }
            parts.append(Partition(
                index=len(parts), start=old_n + start, stop=old_n + stop,
                zone=ZoneMap(n_rows=stop - start,
                             null_count=int((~pvalid).sum()),
                             columns=zones)))
        out = PartitionedTable(combined, parts,
                               partition_by=self.partition_by)
        if self._host_view is not None:
            # extend the memoized host snapshot instead of re-downloading
            # the whole (grown) table on the next sharded serve
            hcols, hvalid = self._host_view
            out._host_view = (
                {k: np.concatenate([hcols[k], bcols[k]]) for k in hcols},
                np.concatenate([hvalid, bvalid]))
        return out

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    @property
    def total_rows(self) -> int:
        return self.table.capacity

    def slice(self, index: int) -> Table:
        p = self.partitions[index]
        return self.table.row_slice(p.start, p.stop)

    def host_view(self):
        """Host numpy snapshot of the base table (columns dict, validity),
        memoized — the table is immutable between registrations and the
        sharded executor gathers partition row ranges host-side on every
        serve, so the device->host transfer should happen once per
        registration, not once per execution."""
        if self._host_view is None:
            self._host_view = (
                {k: to_numpy(v) for k, v in self.table.columns.items()},
                to_numpy(self.table.valid))
        return self._host_view

    def prune(self, constraints: Sequence[Constraint]
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Split partition indices into (surviving, pruned) under a
        conjunctive constraint list.  All-NULL partitions prune even with
        no constraints — they contribute no valid rows to anything."""
        surviving: List[int] = []
        pruned: List[int] = []
        for p in self.partitions:
            if p.zone.n_valid == 0 or not p.zone.may_match_all(constraints):
                pruned.append(p.index)
            else:
                surviving.append(p.index)
        return tuple(surviving), tuple(pruned)

    def __repr__(self):
        by = f", by {self.partition_by!r}" if self.partition_by else ""
        return (f"PartitionedTable[{self.total_rows} rows, "
                f"{self.n_partitions} partitions{by}]")


def _key_ranges(pt: PartitionedTable, column: str
                ) -> Optional[List[Optional[Tuple[float, float]]]]:
    """Per-partition valid-key (min, max) ranges; ``None`` entries for
    partitions with no valid rows, overall ``None`` when any non-empty
    partition lacks zone stats for the column (NaN-poisoned float stats,
    or a non-numeric key) — then nothing can be proven."""
    out: List[Optional[Tuple[float, float]]] = []
    for p in pt.partitions:
        if p.zone.n_valid == 0:
            out.append(None)
            continue
        zone = p.zone.columns.get(column)
        if zone is None or zone.min is None or zone.max is None:
            return None
        out.append((zone.min, zone.max))
    return out


def compatible_partitioning(a: Optional[PartitionedTable],
                            b: Optional[PartitionedTable],
                            on: str) -> bool:
    """Can a join on column ``on`` distribute over aligned partition pairs
    of ``a`` (probe/left side) and ``b`` (build/right side)?

    Requirements, checked — not trusted — from the zone maps:

    - both tables are range-partitioned *on the join column* with equal
      partition counts (index alignment is what "aligned pairs" means);
    - no valid key range of ``a``'s partition ``i`` intersects ``b``'s
      partition ``j`` for any ``i != j``.  Then a valid left row's key can
      only exist inside the same-indexed right partition, so per-partition
      local joins see every match the whole-table join would.  Invalid
      rows need no alignment: the join masks them out on either side.

    Conservative by construction: a partition whose key column has no
    published stats (NaN rows withhold float zone stats) fails the check —
    soundness over coverage, exactly like ``ZoneMap.may_match``."""
    if a is None or b is None:
        return False
    if a.partition_by != on or b.partition_by != on:
        return False
    if a.n_partitions != b.n_partitions or a.n_partitions == 0:
        return False
    ar = _key_ranges(a, on)
    br = _key_ranges(b, on)
    if ar is None or br is None:
        return False
    # vectorized pairwise closed-range intersection test; empty partitions
    # (None) become inverted sentinel ranges that intersect nothing
    alo, ahi = (np.asarray([r[k] if r is not None else s
                            for r in ar])
                for k, s in ((0, np.inf), (1, -np.inf)))
    blo, bhi = (np.asarray([r[k] if r is not None else s
                            for r in br])
                for k, s in ((0, np.inf), (1, -np.inf)))
    overlap = (alo[:, None] <= bhi[None, :]) \
        & (blo[None, :] <= ahi[:, None])
    np.fill_diagonal(overlap, False)       # same index may (should) align
    return not overlap.any()
