"""The rows and the least work of one request, for the metric readers:
the frozen counts (``counts/``) applied to the request's own inputs."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..counts import peaks, tree_sizes, work

_groups: Dict[Tuple[int, str], int] = {}


def _columns_of(run, r) -> Dict[str, np.ndarray]:
    """The columns of the rows request ``r`` read: the stored tables, or
    the pool rows its own table was copied from."""
    if not r.req.rows:
        return run.columns
    start, count = r.req.rows
    return {c: a[start:start + count] for c, a in run.columns.items()}


def model_rows(run, r) -> int:
    """Rows the model had to score for request ``r``."""
    m, _ = work.model_rows(r.req.query["expect"], r.req.binding,
                           _columns_of(run, r), run.cfg.get("key"))
    return m


def least_seconds(run, r) -> float:
    """Least seconds of request ``r``'s work on the card."""
    expect = r.req.query["expect"]
    groups = 0
    if expect["kind"] == "group_avg":
        src = expect["key"][1]
        k = (id(run.columns[src]), src)
        if k not in _groups:
            _groups[k] = len(np.unique(run.columns[src]))
        groups = _groups[k]
    ops, nbytes = work.query_work(
        expect, r.req.binding, _columns_of(run, r), run.cfg.get("key"),
        run.model_kind.input_columns(run.model_state),
        run.model_kind.ops_per_row(run.model_state), groups)
    return peaks.least_seconds(ops, nbytes)


def forest_sizes(run) -> Tuple[int, list, int]:
    """(F, each tree's reachable (internal nodes, leaves), O) of the run's
    forest, its features bounded by their range over the stored data."""
    if "forest_sizes" not in run.cache:
        state = run.model_state
        sc = state["featurizers"][0]
        inv = np.float32(1.0) / np.asarray(sc["std"], np.float32)
        bounds = []
        for j, c in enumerate(sc["columns"]):
            x = run.columns[c].astype(np.float32)
            lo, hi = x.min(), x.max()
            bounds.append(tuple(float((v - sc["mean"][j]) * inv[j])
                                for v in (lo, hi)))
        trees = state["model"]["trees"]
        sizes = [tree_sizes.reachable(t, bounds) for t in trees]
        run.cache["forest_sizes"] = (
            len(sc["columns"]), sizes,
            int(np.asarray(trees[0]["value"]).shape[1]))
    return run.cache["forest_sizes"]
