"""The least work a query needs, whatever implements it.

A request needs its model evaluated on the rows that pass its relational
filters (a range on the table's sorted key selects its rows without
reading the others; any other filter column is read on every row), the
columns it uses read once on those rows, and its answer written once.
Every column is 4 bytes a row.  A predicate on the model's output filters
after the model, so it needs the model on every row that reaches it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from ..reference.query import MODEL_SOURCES, OPS, bound

VALUE_BYTES = 4


def model_rows(expect: Mapping, binding: Mapping,
               columns: Mapping[str, np.ndarray], key) -> Tuple[int, Dict]:
    """(rows the model is needed on, {filter column: rows it is read on})"""
    n = len(next(iter(columns.values())))
    keep = np.ones(n, bool)
    reads: Dict[str, int] = {}
    for src, op, value in expect.get("filter", []):
        if src in MODEL_SOURCES:
            continue
        keep &= OPS[op](columns[src], bound(value, binding))
        reads[src] = n
    m = int(keep.sum())
    if key in reads:
        reads[key] = m
    return m, reads


def query_work(expect: Mapping, binding: Mapping,
               columns: Mapping[str, np.ndarray], key,
               model_columns: Sequence[str], ops_per_row: Mapping[str, float],
               groups: int) -> Tuple[Dict[str, float], float]:
    """(operations by class, bytes) of one request.  ``groups`` bounds a
    grouped answer's rows."""
    m, reads = model_rows(expect, binding, columns, key)
    used = list(model_columns)
    kind = expect["kind"]
    if kind == "rows":
        out_cols = list(expect["columns"].values())
        out_rows = m
    elif kind == "group_avg":
        out_cols = [expect["key"][1], expect["avg"][1]]
        out_rows = groups
    else:
        out_cols = [expect["key"][1], expect["order"][1]]
        out_rows = min(int(expect["k"]), m)
    used += [c for c in out_cols if c not in MODEL_SOURCES]
    for c in used:
        reads.setdefault(c, m)
    nbytes = VALUE_BYTES * (sum(reads.values()) + out_rows * len(out_cols))
    return {k: v * m for k, v in ops_per_row.items()}, float(nbytes)

