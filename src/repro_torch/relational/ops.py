"""Relational operators over :class:`repro_torch.relational.table.Table` in
plain torch.

Every operator keeps shapes static and therefore expresses selection via
validity masks.  Aggregations/joins respect the masks, so SQL bag semantics
hold.  The operators run eagerly on the device of the tables they get.

Two properties the JAX package gets for free are kept by hand here:

- sorts are stable (``jnp.argsort`` is; ``torch.argsort`` is only with
  ``stable=True``), so ties — masked keys at the sentinel, equal ORDER BY
  keys — resolve by row position exactly as in the reference;
- grouped float sums are deterministic: the CUDA scatter-adds behind
  ``index_add_``/``scatter_reduce`` use atomics whose order changes from
  run to run, so :func:`segment_sum` sorts rows by segment (stable) and
  reduces each segment with ``torch.segment_reduce``, which adds a
  segment's rows in row order on the CPU (the order of the reference's
  scatter-add there) and in one fixed order on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .expr import Expr, value_tensor
from .table import ColumnSchema, Schema, Table

__all__ = [
    "filter_", "project", "with_column", "join_unique", "group_aggregate",
    "partial_aggregate", "combine_partials", "merge_partial_states",
    "order_by", "limit",
    "union_all", "AGGREGATIONS", "COMBINABLE_AGGS", "segment_sum",
    "segment_min", "segment_max",
]

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -2 ** 31


def filter_(table: Table, predicate: Expr) -> Table:
    """sigma: narrow the validity mask; no data movement."""
    mask = value_tensor(predicate.evaluate(table.columns), table.valid)
    return table.with_valid(torch.logical_and(table.valid,
                                              mask.to(torch.bool)))


def project(table: Table, names: Sequence[str]) -> Table:
    """pi: keep only ``names`` columns."""
    return table.select(names)


def with_column(table: Table, name: str, expr: Expr,
                field: Optional[ColumnSchema] = None) -> Table:
    """Extended projection: add/replace a computed column."""
    value = value_tensor(expr.evaluate(table.columns), table.valid)
    fields = [field] if field is not None else None
    return table.with_columns({name: value}, fields)


def join_unique(left: Table, right: Table, on: str,
                how: str = "inner",
                suffix: str = "_r") -> Table:
    """Equi-join where ``right`` has at most one live row per key (FK join).

    Output capacity equals the left capacity: for every left row we locate
    its right match with a stable sort + searchsorted probe.  Rows without
    a match are invalidated (inner) or kept with garbage-but-masked right
    columns ("left_mark" adds a ``__matched`` column).
    """
    if how not in ("inner", "left_mark"):
        raise ValueError(f"unsupported join type {how}")
    lkeys = left.column(on)
    rkeys = right.column(on)
    # Sort right side by key, pushing invalid rows to the end with a sentinel.
    big = float("inf") if rkeys.is_floating_point() else _INT32_MAX
    rkeys_masked = torch.where(right.valid, rkeys,
                               torch.full_like(rkeys, big))
    order = torch.argsort(rkeys_masked, stable=True)
    rkeys_sorted = rkeys_masked[order]
    pos = torch.searchsorted(rkeys_sorted, lkeys.to(rkeys_sorted.dtype))
    pos = torch.clamp(pos, 0, rkeys_sorted.shape[0] - 1)
    matched = rkeys_sorted[pos] == lkeys
    src = order[pos]

    cols: Dict[str, torch.Tensor] = dict(left.columns)
    fields = list(left.schema.columns)
    for name in right.names:
        if name == on:
            continue
        out_name = name if name not in cols else name + suffix
        cols[out_name] = right.column(name)[src]
        f = right.schema.field(name)
        fields.append(ColumnSchema(out_name, f.dtype, f.dictionary))
    valid = left.valid
    if how == "inner":
        valid = torch.logical_and(valid, matched)
    else:
        cols["__matched"] = matched
        fields.append(ColumnSchema("__matched", torch.bool))
    return Table(cols, valid, Schema(tuple(fields)))


# -- reductions in the reference's dtypes ------------------------------------

def _sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` dtypes: bool and int32 sum to int32, floats keep theirs."""
    if x.dtype == torch.bool or not x.is_floating_point():
        return torch.sum(x.to(torch.int32), dtype=torch.int32)
    return torch.sum(x)


def _agg_sum(values, mask):
    return _sum(torch.where(mask, values, torch.zeros_like(values)))


def _agg_count(values, mask):
    return _sum(mask)


def _agg_mean(values, mask):
    n = torch.clamp_min(_sum(mask.to(values.dtype)), 1)
    return _agg_sum(values, mask) / n


def _agg_min(values, mask):
    big = float("inf") if values.is_floating_point() else _INT32_MAX
    return torch.min(torch.where(mask, values, torch.full_like(values, big)))


def _agg_max(values, mask):
    small = float("-inf") if values.is_floating_point() else _INT32_MIN
    return torch.max(torch.where(mask, values,
                                 torch.full_like(values, small)))


AGGREGATIONS: Dict[str, Callable] = {
    "sum": _agg_sum,
    "count": _agg_count,
    "avg": _agg_mean,
    "mean": _agg_mean,
    "min": _agg_min,
    "max": _agg_max,
}


def _segment_reduce(values: torch.Tensor, seg: torch.Tensor,
                    num_segments: int, reduce: str) -> torch.Tensor:
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=num_segments)
    return torch.segment_reduce(values[order], reduce, lengths=lengths,
                                unsafe=True)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Deterministic per-segment sums; ``seg`` in ``[0, num_segments)``.
    Empty segments sum to 0."""
    return _segment_reduce(values, seg, num_segments, "sum")


def segment_min(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment minima; empty segments hold +inf."""
    return _segment_reduce(values, seg, num_segments, "min")


def segment_max(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maxima; empty segments hold -inf."""
    return _segment_reduce(values, seg, num_segments, "max")


def _resolve_num_groups(table: Table, key: str,
                        num_groups: Optional[int]) -> Tuple[int, ColumnSchema]:
    """Static group count for a keyed aggregation — shared by the one-shot
    and the partial/combine (two-phase) paths so their group spaces can
    never diverge."""
    field = table.schema.field(key)
    if num_groups is not None:
        return int(num_groups), field
    if field.dictionary is not None:
        return len(field.dictionary), field
    column = table.column(key)
    if not column.is_floating_point() and column.dtype != torch.bool:
        # small-domain integer key: group over code range [0, 256);
        # empty groups are masked out (counts == 0)
        return 256, field
    raise ValueError(f"group key {key!r} is not dictionary-encoded "
                     f"and not integer; pass num_groups")


def _segments(table: Table, key: str, num_groups: int) -> torch.Tensor:
    """Segment id per row; invalid rows (and codes outside the group range,
    which the reference's scatter drops) go to an overflow bucket that the
    caller drops.  int64, since torch indexes with it."""
    codes = table.column(key).to(torch.int64)
    keep = table.valid & (codes >= 0) & (codes < num_groups)
    return torch.where(keep, codes, torch.full_like(codes, num_groups))


def _float_source(table: Table, column: Optional[str]) -> torch.Tensor:
    mask = table.valid
    return table.column(column).to(torch.float32) if column is not None \
        else mask.to(torch.float32)


def group_aggregate(table: Table, key: Optional[str],
                    aggs: Mapping[str, Tuple[str, str]],
                    num_groups: Optional[int] = None) -> Table:
    """GROUP BY ``key`` with aggregates ``{out_name: (fn, column)}``.

    ``key=None`` means a global aggregate (one output row).  For grouped
    aggregation the number of groups must be statically known: either the key
    column is dictionary-encoded (group count = dictionary size) or the caller
    passes ``num_groups``.
    """
    mask = table.valid
    dev = mask.device
    if key is None:
        cols: Dict[str, torch.Tensor] = {}
        fields: List[ColumnSchema] = []
        for out_name, (fn, column) in aggs.items():
            src = table.column(column) if column is not None else mask
            val = AGGREGATIONS[fn](src, mask)
            cols[out_name] = val[None]
            fields.append(ColumnSchema(out_name, val.dtype))
        return Table(cols, torch.ones((1,), dtype=torch.bool, device=dev),
                     Schema(tuple(fields)))

    num_groups, field = _resolve_num_groups(table, key, num_groups)
    seg = _segments(table, key, num_groups)
    cols = {key: torch.arange(num_groups, dtype=torch.int32, device=dev)}
    fields = [ColumnSchema(key, torch.int32, field.dictionary)]
    counts = segment_sum(mask.to(torch.float32), seg,
                         num_groups + 1)[:num_groups]
    for out_name, (fn, column) in aggs.items():
        src = _float_source(table, column)
        masked = torch.where(mask, src, torch.zeros_like(src))
        if fn in ("sum", "avg", "mean", "count"):
            total = segment_sum(masked, seg, num_groups + 1)[:num_groups]
            if fn == "sum":
                val = total
            elif fn == "count":
                val = counts
            else:
                val = total / torch.clamp_min(counts, 1.0)
        elif fn == "min":
            sentinel = torch.where(mask, src, torch.full_like(src, float("inf")))
            val = segment_min(sentinel, seg, num_groups + 1)[:num_groups]
        elif fn == "max":
            sentinel = torch.where(mask, src,
                                   torch.full_like(src, float("-inf")))
            val = segment_max(sentinel, seg, num_groups + 1)[:num_groups]
        else:
            raise ValueError(f"unknown aggregate {fn}")
        cols[out_name] = val
        fields.append(ColumnSchema(out_name, val.dtype))
    valid = counts > 0
    return Table(cols, valid, Schema(tuple(fields)))


# ---------------------------------------------------------------------------
# Two-phase (partial + combine) aggregation — the distributed twin of
# ``group_aggregate``.  ``partial_aggregate`` runs once per data morsel and
# emits *mergeable state* instead of final values; ``combine_partials``
# folds the per-morsel states into exactly the table ``group_aggregate``
# would have produced over the union of the morsels' rows.  State
# decomposition: sum -> sum, count -> count, min -> min, max -> max,
# mean/avg -> (sum, count) with the division only at combine time.
#
# Determinism contract: combining the same partials in the same order is
# bit-exact however many devices produced them (the executor always
# combines in ascending partition order).  Against *one-shot* aggregation
# the results are exact for min/max/count and for sums of exactly-
# representable values; general float sums can differ in the last ulp
# because addition is reassociated across morsels.
# ---------------------------------------------------------------------------

# Aggregation functions with a mergeable partial state (the set the
# ``distributed_plan`` rule accepts for a two-phase rewrite).
COMBINABLE_AGGS = frozenset({"sum", "count", "avg", "mean", "min", "max"})

_PCOUNT = "__pcount"       # per-group valid-row counts, always carried


def partial_aggregate(table: Table, key: Optional[str],
                      aggs: Mapping[str, Tuple[str, str]],
                      num_groups: Optional[int] = None) -> Table:
    """Per-morsel aggregation state for a later :func:`combine_partials`.

    Output shape is static (``num_groups`` rows keyed, one row global).  All
    rows are marked valid — the rows are *states*, not bag tuples; group
    emptiness travels in the ``__pcount`` column and only the combine
    stage turns it back into validity."""
    unknown = {f for f, _ in aggs.values()} - COMBINABLE_AGGS
    if unknown:
        raise ValueError(f"aggregates {sorted(unknown)} have no mergeable "
                         f"partial state; combinable: "
                         f"{sorted(COMBINABLE_AGGS)}")
    dev = table.device
    if table.capacity == 0:
        # one all-invalid row yields exactly the identity states (0
        # sums/counts, sentinel min/max) at the right dtypes through the
        # same code path
        table = Table({k: torch.zeros((1,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device=dev)
                       for k, v in table.columns.items()},
                      torch.zeros((1,), dtype=torch.bool, device=dev),
                      table.schema)
    mask = table.valid
    if key is None:
        cols: Dict[str, torch.Tensor] = {
            _PCOUNT: _agg_count(None, mask)[None]}
        fields: List[ColumnSchema] = [ColumnSchema(_PCOUNT, torch.int32)]
        for out_name, (fn, column) in aggs.items():
            src = table.column(column) if column is not None else mask
            if fn in ("mean", "avg"):
                # pre-max count in the value dtype: _agg_mean divides by
                # max(sum(mask.astype(values.dtype)), 1) — the combine
                # stage must apply the max only to the *total*
                cols[out_name + "@sum"] = _agg_sum(src, mask)[None]
                cols[out_name + "@n"] = _sum(mask.to(src.dtype))[None]
                fields += [
                    ColumnSchema(out_name + "@sum",
                                 cols[out_name + "@sum"].dtype),
                    ColumnSchema(out_name + "@n",
                                 cols[out_name + "@n"].dtype)]
            else:
                val = AGGREGATIONS[fn](src, mask)
                cols[out_name] = val[None]
                fields.append(ColumnSchema(out_name, val.dtype))
        return Table(cols, torch.ones((1,), dtype=torch.bool, device=dev),
                     Schema(tuple(fields)))

    num_groups, field = _resolve_num_groups(table, key, num_groups)
    seg = _segments(table, key, num_groups)
    counts = segment_sum(mask.to(torch.float32), seg,
                         num_groups + 1)[:num_groups]
    cols = {key: torch.arange(num_groups, dtype=torch.int32, device=dev),
            _PCOUNT: counts}
    fields = [ColumnSchema(key, torch.int32, field.dictionary),
              ColumnSchema(_PCOUNT, counts.dtype)]

    def seg_sum(src):
        return segment_sum(torch.where(mask, src, torch.zeros_like(src)),
                           seg, num_groups + 1)[:num_groups]

    for out_name, (fn, column) in aggs.items():
        src = _float_source(table, column)
        if fn == "sum":
            state = {out_name: seg_sum(src)}
        elif fn == "count":
            state = {out_name: counts}
        elif fn in ("mean", "avg"):
            state = {out_name + "@sum": seg_sum(src)}
        elif fn == "min":
            state = {out_name: segment_min(
                torch.where(mask, src, torch.full_like(src, float("inf"))),
                seg, num_groups + 1)[:num_groups]}
        else:                                    # max
            state = {out_name: segment_max(
                torch.where(mask, src, torch.full_like(src, float("-inf"))),
                seg, num_groups + 1)[:num_groups]}
        for cname, val in state.items():
            cols[cname] = val
            fields.append(ColumnSchema(cname, val.dtype))
    return Table(cols, torch.ones((num_groups,), dtype=torch.bool, device=dev),
                 Schema(tuple(fields)))


def _stacked(partials: Sequence[Table], name: str) -> torch.Tensor:
    dev = partials[0].device
    return torch.stack([p.columns[name].to(dev) for p in partials], dim=0)


def _fold_sum(s: torch.Tensor) -> torch.Tensor:
    """Sum over the partials axis in partial order (fixed, deterministic)."""
    out = s[0]
    for i in range(1, s.shape[0]):
        out = out + s[i]
    return out


def combine_partials(partials: Sequence[Table], key: Optional[str],
                     aggs: Mapping[str, Tuple[str, str]]) -> Table:
    """Fold :func:`partial_aggregate` outputs into the final aggregate
    table — column names, dtypes and validity identical to
    ``group_aggregate`` over the concatenation of the morsels' input rows.
    Tiny (``num_groups x n_morsels`` elements); callers pass partials in
    ascending partition order for cross-placement determinism.
    """
    if not partials:
        raise ValueError("combine_partials needs at least one partial")
    base = partials[0]
    dev = base.device

    def stacked(name: str) -> torch.Tensor:
        return _stacked(partials, name)

    if key is None:
        cols: Dict[str, torch.Tensor] = {}
        fields: List[ColumnSchema] = []
        for out_name, (fn, _column) in aggs.items():
            if fn in ("sum", "count"):
                val = _fold_sum(stacked(out_name))[0]
            elif fn in ("mean", "avg"):
                total = _fold_sum(stacked(out_name + "@sum"))[0]
                n = _fold_sum(stacked(out_name + "@n"))[0]
                val = total / torch.clamp_min(n, 1)
            elif fn == "min":
                val = torch.amin(stacked(out_name), dim=0)[0]
            else:                                # max
                val = torch.amax(stacked(out_name), dim=0)[0]
            cols[out_name] = val[None]
            fields.append(ColumnSchema(out_name, val.dtype))
        return Table(cols, torch.ones((1,), dtype=torch.bool, device=dev),
                     Schema(tuple(fields)))

    counts = _fold_sum(stacked(_PCOUNT))
    num_groups = int(counts.shape[0])
    field = base.schema.field(key)
    cols = {key: torch.arange(num_groups, dtype=torch.int32, device=dev)}
    fields = [ColumnSchema(key, torch.int32, field.dictionary)]
    for out_name, (fn, _column) in aggs.items():
        if fn == "sum":
            val = _fold_sum(stacked(out_name))
        elif fn == "count":
            val = counts
        elif fn in ("mean", "avg"):
            val = _fold_sum(stacked(out_name + "@sum")) \
                / torch.clamp_min(counts, 1.0)
        elif fn == "min":
            val = torch.amin(stacked(out_name), dim=0)
        else:                                    # max
            val = torch.amax(stacked(out_name), dim=0)
        cols[out_name] = val
        fields.append(ColumnSchema(out_name, val.dtype))
    return Table(cols, counts > 0, Schema(tuple(fields)))


def merge_partial_states(partials: Sequence[Table], key: Optional[str],
                         aggs: Mapping[str, Tuple[str, str]]) -> Table:
    """Fold several :func:`partial_aggregate` states into **one
    still-partial** state (incremental view maintenance support).

    Where :func:`combine_partials` finalizes (turning counts back into
    validity and dividing means out), this keeps the state mergeable: sums,
    counts and ``@sum``/``@n`` columns add, ``min``/``max`` fold, the key
    column and schema pass through.  For integer-valued data (and
    min/max/count always) the fold is exact; general float sums
    reassociate — the same contract the sharded two-phase path carries."""
    if not partials:
        raise ValueError("merge_partial_states needs at least one partial")
    if len(partials) == 1:
        return partials[0]
    base = partials[0]

    fold_ops: Dict[str, str] = {_PCOUNT: "sum"}
    for out_name, (fn, _column) in aggs.items():
        if fn in ("mean", "avg"):
            fold_ops[out_name + "@sum"] = "sum"
            fold_ops[out_name + "@n"] = "sum"   # global states only
        elif fn in ("min", "max"):
            fold_ops[out_name] = fn
        else:                                    # sum, count
            fold_ops[out_name] = "sum"

    cols: Dict[str, torch.Tensor] = {}
    fields: List[ColumnSchema] = []
    for f in base.schema.columns:
        if key is not None and f.name == key:
            cols[f.name] = base.columns[f.name]
            fields.append(f)
            continue
        op = fold_ops[f.name]
        s = _stacked(partials, f.name)
        if op == "min":
            val = torch.amin(s, dim=0)
        elif op == "max":
            val = torch.amax(s, dim=0)
        else:
            val = _fold_sum(s)
        cols[f.name] = val
        fields.append(ColumnSchema(f.name, val.dtype, f.dictionary))
    return Table(cols, base.valid, Schema(tuple(fields)))


def order_by(table: Table, key: str, descending: bool = False) -> Table:
    """Total order on ``key``; invalid rows sort last regardless.  Stable:
    equal keys keep their physical order, as with ``jnp.argsort``."""
    keys = table.column(key).to(torch.float32)
    if descending:
        keys = -keys
    keys = torch.where(table.valid, keys, torch.full_like(keys, float("inf")))
    order = torch.argsort(keys, stable=True)
    cols = {n: v[order] for n, v in table.columns.items()}
    return Table(cols, table.valid[order], table.schema)


def limit(table: Table, n: int) -> Table:
    """Keep the first ``n`` live rows (by current physical order)."""
    rank = torch.cumsum(table.valid.to(torch.int32), 0,
                        dtype=torch.int32) - 1
    keep = torch.logical_and(table.valid, rank < n)
    return table.with_valid(keep)


def union_all(a: Table, b: Table) -> Table:
    """Bag union; schemas must align by name."""
    if set(a.names) != set(b.names):
        raise ValueError(f"schema mismatch: {a.names} vs {b.names}")
    cols = {n: torch.cat([a.column(n), b.column(n)]) for n in a.names}
    valid = torch.cat([a.valid, b.valid])
    return Table(cols, valid, a.schema)
