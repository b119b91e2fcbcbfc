"""Shared analysis helpers for the cross-optimizer rules."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ...relational.expr import (CaseWhen, Col, Const, Constraint, Expr,
                                UnaryOp, extract_constraints)
from ..ir import Category, Node, Plan

ALL = "__ALL__"


# ---------------------------------------------------------------------------
# Plan-shape helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PredictChain:
    """featurize -> predict -> attach triple for one model invocation."""

    featurize: Node
    predict: Node
    attach: Optional[Node]
    table_input: str       # node id feeding featurize


def find_predict_chains(plan: Plan) -> List[PredictChain]:
    chains = []
    for n in plan.topo_ordered_nodes():
        if n.op != "predict_model":
            continue
        feat = plan.node(n.inputs[0]) if n.inputs else None
        if feat is None or feat.op != "featurize":
            continue
        attach = None
        for cid in plan.consumers(n.id):
            c = plan.node(cid)
            if c.op == "attach_column":
                attach = c
                break
        chains.append(PredictChain(feat, n, attach, feat.inputs[0]))
    return chains


def upstream_constraints(plan: Plan, table_node_id: str, catalog,
                         use_stats: bool) -> List[Constraint]:
    """Collect column constraints that provably hold for every live row
    reaching ``table_node_id``: WHERE-clause conjuncts on the path plus
    (optionally) registered table statistics (§4.1 'data properties')."""
    out: List[Constraint] = []
    renames: Dict[str, str] = {}   # current name -> original name

    def visit(nid: str):
        n = plan.node(nid)
        if n.op == "filter":
            for c in extract_constraints(n.attrs["predicate"]):
                name = renames.get(c.column, c.column)
                out.append(Constraint(name, c.kind, c.value))
            visit(n.inputs[0])
        elif n.op in ("attach_column", "map", "project", "order_by", "limit"):
            visit(n.inputs[0])
        elif n.op == "rename":
            for old, new in n.attrs["mapping"].items():
                renames[new] = old
            visit(n.inputs[0])
        elif n.op == "join":
            visit(n.inputs[0])
            visit(n.inputs[1])
        elif n.op == "scan" and use_stats:
            try:
                stats = catalog.get_stats(n.attrs["table"])
            except Exception:
                stats = {}
            for cname, st in stats.items():
                out.append(Constraint(cname, ">=", st.min))
                out.append(Constraint(cname, "<=", st.max))

    visit(table_node_id)
    return out


# ---------------------------------------------------------------------------
# Constraint -> feature-space mapping
# ---------------------------------------------------------------------------

def _interval_from(constraints: List[Constraint]) -> Tuple[float, float]:
    """Intersect constraints on one column into a closed [lo, hi]."""
    lo, hi = -np.inf, np.inf
    for c in constraints:
        v = float(c.value)
        if c.kind == "==":
            lo, hi = max(lo, v), min(hi, v)
        elif c.kind == ">=":
            lo = max(lo, v)
        elif c.kind == ">":
            lo = max(lo, float(np.nextafter(v, np.inf)))
        elif c.kind == "<=":
            hi = min(hi, v)
        elif c.kind == "<":
            hi = min(hi, float(np.nextafter(v, -np.inf)))
        # "!=" cannot be expressed as an interval; ignored (sound).
    return lo, hi


def feature_bounds(featurizers: Sequence[Any],
                   constraints: List[Constraint]
                   ) -> Dict[int, Tuple[float, float]]:
    """Translate column-space constraints into global-feature-index bounds.

    Handles featurizer semantics: StandardScaler affine-maps the interval;
    Imputer widens it to include the fill value (NaN rows map there);
    OneHotEncoder/Bucketizer features collapse to [0,0] / [1,1] constants
    when the constraint pins or excludes their category.  Only *provable*
    bounds are produced — unknown featurizers contribute nothing.
    """
    by_col: Dict[str, List[Constraint]] = {}
    for c in constraints:
        by_col.setdefault(c.column, []).append(c)

    bounds: Dict[int, Tuple[float, float]] = {}
    offset = 0
    for f in featurizers:
        m = f.mapping()
        kind = getattr(f, "kind", None)
        for i in range(m.n_features):
            gidx = offset + i
            src = m.source[i]
            if src not in by_col:
                continue
            lo, hi = _interval_from(by_col[src])
            if lo == -np.inf and hi == np.inf:
                continue
            if kind == "scaler":
                j = f.columns.index(src)
                mu, sd = float(f.mean[j]), float(f.std[j])
                flo = (lo - mu) / sd if np.isfinite(lo) else -np.inf
                fhi = (hi - mu) / sd if np.isfinite(hi) else np.inf
                bounds[gidx] = (flo, fhi)
            elif kind == "imputer":
                j = f.columns.index(src)
                fill = float(f.fill[j])
                bounds[gidx] = (min(lo, fill), max(hi, fill))
            elif kind == "one_hot":
                cat = m.category[i]
                if lo == hi:                       # col == lo pinned
                    v = 1.0 if cat == lo else 0.0
                    bounds[gidx] = (v, v)
                elif cat < lo or cat > hi:         # category excluded
                    bounds[gidx] = (0.0, 0.0)
            elif kind == "bucketizer":
                bnd = np.asarray(f.boundaries)
                blo = int(np.searchsorted(bnd, lo)) if np.isfinite(lo) else 0
                bhi = int(np.searchsorted(bnd, hi)) if np.isfinite(hi) \
                    else len(bnd)
                cat = m.category[i]
                if cat < blo or cat > bhi:
                    bounds[gidx] = (0.0, 0.0)
                elif blo == bhi and cat == blo:
                    bounds[gidx] = (1.0, 1.0)
            else:   # passthrough-like featurizer: identity mapping
                if kind is None:
                    bounds[gidx] = (lo, hi)
        offset += m.n_features
    return bounds


def constant_features(bounds: Dict[int, Tuple[float, float]]
                      ) -> Dict[int, float]:
    return {i: lo for i, (lo, hi) in bounds.items() if lo == hi}


# ---------------------------------------------------------------------------
# Featurizer restriction (projection pushdown machinery)
# ---------------------------------------------------------------------------

def restrict_featurizers(featurizers: Sequence[Any], keep: Set[int]
                         ) -> Tuple[List[Any], Dict[int, int]]:
    """Rebuild featurizers keeping only global feature indices in ``keep``.

    Returns (new_featurizers, old_global_index -> new_global_index).
    """
    new_feats: List[Any] = []
    index_map: Dict[int, int] = {}
    offset = 0
    new_offset = 0
    for f in featurizers:
        n = f.mapping().n_features
        local_keep = [i for i in range(n) if offset + i in keep]
        if local_keep:
            if len(local_keep) == n:
                nf = f
            else:
                if not hasattr(f, "restrict"):
                    nf = f           # can't shrink: keep whole block
                    local_keep = list(range(n))
                else:
                    nf = f.restrict(local_keep)
            new_feats.append(nf)
            for new_local, old_local in enumerate(local_keep):
                index_map[offset + old_local] = new_offset + new_local
            new_offset += len(local_keep)
        offset += n
    return new_feats, index_map


def input_columns_of(featurizers: Sequence[Any]) -> List[str]:
    cols: List[str] = []
    for f in featurizers:
        for c in f.mapping().source:
            if c not in cols:
                cols.append(c)
    return cols


# ---------------------------------------------------------------------------
# Column flow analysis (for pushdown / join elimination)
# ---------------------------------------------------------------------------

def produced_columns(plan: Plan, catalog) -> Dict[str, Set[str]]:
    """Forward pass: columns available at the output of each table node."""
    out: Dict[str, Set[str]] = {}
    for nid in plan.topo_order():
        n = plan.node(nid)
        if n.out_kind != "table":
            continue
        if n.op == "scan":
            try:
                out[nid] = set(catalog.get_table(n.attrs["table"]).names)
            except Exception:
                out[nid] = set()
        elif n.op == "join":
            out[nid] = out.get(n.inputs[0], set()) | out.get(n.inputs[1],
                                                             set())
        elif n.op == "attach_column":
            out[nid] = out.get(n.inputs[0], set()) | {n.attrs["name"]}
        elif n.op == "map":
            out[nid] = out.get(n.inputs[0], set()) | {n.attrs["name"]}
        elif n.op == "rename":
            base = out.get(n.inputs[0], set())
            m = n.attrs["mapping"]
            out[nid] = {m.get(c, c) for c in base}
        elif n.op == "project":
            out[nid] = set(n.attrs["columns"])
        elif n.op == "group_agg":
            cols = set(n.attrs["aggs"])
            if n.attrs["key"]:
                cols.add(n.attrs["key"])
            out[nid] = cols
        elif n.inputs:
            out[nid] = out.get(n.inputs[0], set())
        else:
            out[nid] = set()
    return out


def required_columns(plan: Plan, catalog) -> Dict[str, Set[str]]:
    """Backward pass: columns demanded *from* each table node's output.

    The sentinel column ``ALL`` means "everything" (no final projection)."""
    req: Dict[str, Set[str]] = {nid: set() for nid in plan.nodes}
    if plan.output is not None:
        req[plan.output] = {ALL}
    for nid in reversed(plan.topo_order()):
        n = plan.node(nid)
        need = req[nid]
        if n.op == "scan":
            continue
        if n.op == "filter":
            down = set(need)
            down |= n.attrs["predicate"].references()
            req[n.inputs[0]] |= down
        elif n.op == "project":
            req[n.inputs[0]] |= set(n.attrs["columns"])
        elif n.op == "rename":
            inv = {v: k for k, v in n.attrs["mapping"].items()}
            req[n.inputs[0]] |= {inv.get(c, c) for c in need}
        elif n.op == "map":
            down = (need - {n.attrs["name"]}) | n.attrs["expr"].references()
            req[n.inputs[0]] |= down
        elif n.op == "attach_column":
            req[n.inputs[0]] |= (need - {n.attrs["name"]})
            for other in n.inputs[1:]:
                req[other] |= set()
        elif n.op == "join":
            key = n.attrs["on"]
            down = set(need) | {key}
            req[n.inputs[0]] |= down
            req[n.inputs[1]] |= down
        elif n.op == "group_agg":
            cols = {c for (_, c) in n.attrs["aggs"].values() if c}
            if n.attrs["key"]:
                cols.add(n.attrs["key"])
            req[n.inputs[0]] |= cols
        elif n.op == "order_by":
            req[n.inputs[0]] |= set(need) | {n.attrs["key"]}
        elif n.op in ("limit", "union"):
            for i in n.inputs:
                req[i] |= set(need)
        elif n.op == "featurize":
            req[n.inputs[0]] |= set(n.attrs["input_columns"])
        elif n.op == "udf":
            for i in n.inputs:
                req[i] |= {ALL}
        else:
            for i in n.inputs:
                req[i] |= set(need)
    return req


# ---------------------------------------------------------------------------
# Featurizer -> column-space expression (for model inlining)
# ---------------------------------------------------------------------------

def feature_exprs(featurizers: Sequence[Any]) -> Optional[List[Expr]]:
    """Per-feature relational expression, or None if any featurizer is not
    invertible to column space."""
    exprs: List[Expr] = []
    for f in featurizers:
        kind = getattr(f, "kind", None)
        m = f.mapping()
        if kind == "scaler":
            for i, c in enumerate(f.columns):
                mu, sd = float(f.mean[i]), float(f.std[i])
                exprs.append((Col(c) - Const(mu)) * Const(1.0 / sd))
        elif kind == "imputer":
            for i, c in enumerate(f.columns):
                fill = Const(float(f.fill[i]))
                exprs.append(CaseWhen(((UnaryOp("isnan", Col(c)), fill),),
                                      Col(c)))
        elif kind == "one_hot":
            for i in range(m.n_features):
                exprs.append(Col(m.source[i]) == Const(m.category[i]))
        else:
            return None
    return exprs
