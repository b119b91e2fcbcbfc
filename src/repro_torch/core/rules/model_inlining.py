"""Model inlining: small decision trees -> relational CASE expressions
(paper §4.2, Fig 2c; the Froid/UDF-inlining analogue).

The featurize+predict+attach chain collapses into a single relational ``map``
node whose expression is the tree unrolled as nested CASE WHEN over *source
columns* (featurizer semantics are inverted into column expressions).  The
relational engine then runs the whole thing as one
scalar program: no tensor materialization, no ML-runtime hop.
"""

from __future__ import annotations

import numpy as np

from ...relational.expr import CaseWhen, Const, Expr
from ..ir import Category, Node, Plan
from .common import feature_exprs, find_predict_chains


def _leaf_scalar(value: np.ndarray, task: str, proba: bool) -> float:
    if task == "regression" or value.shape[0] == 1:
        return float(value[0])
    if proba:
        return float(value[1]) if value.shape[0] == 2 \
            else float(value.max())
    return float(np.argmax(value))


def _tree_to_expr(tree, feats, task: str, proba: bool, node: int = 0) -> Expr:
    if tree.left[node] < 0:
        return Const(_leaf_scalar(tree.value[node], task, proba))
    cond = feats[int(tree.feature[node])] <= Const(float(tree.threshold[node]))
    left = _tree_to_expr(tree, feats, task, proba, int(tree.left[node]))
    right = _tree_to_expr(tree, feats, task, proba, int(tree.right[node]))
    return CaseWhen(((cond, left),), right)


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    rows = None
    for chain in find_predict_chains(plan):
        model = chain.predict.attrs["model"]
        if getattr(model, "kind", None) != "decision_tree":
            continue
        if getattr(cfg, "cost_based", False):
            from ..cost_model import (CostParams, backend_of,
                                      choose_tree_impl, estimate_rows)
            if rows is None:
                rows = estimate_rows(plan, catalog)
            n_feat = sum(f.mapping().n_features
                         for f in chain.featurize.attrs["featurizers"])
            choice = choose_tree_impl(
                model, rows.get(chain.table_input, 1e6), n_feat,
                CostParams.for_backend(backend_of(catalog)))
            if choice != "inline_case":
                continue
        elif model.tree.n_nodes > cfg.inline_max_nodes:
            continue
        if chain.attach is None:
            continue
        feats = feature_exprs(chain.featurize.attrs["featurizers"])
        if feats is None:
            continue
        expr = _tree_to_expr(model.tree, feats,
                             chain.predict.attrs.get("task", "classification"),
                             chain.predict.attrs.get("proba", False))
        mapped = Node(op="map", category=Category.RA,
                      inputs=[chain.table_input],
                      attrs={"name": chain.attach.attrs["name"],
                             "expr": expr},
                      out_kind="table")
        plan.add(mapped)
        plan.rewire(chain.attach.id, mapped.id)
        plan.prune_dead()
        changed = True
        report.log("model_inlining",
                   f"{chain.predict.attrs.get('model_name')}: inlined "
                   f"{model.tree.n_nodes}-node tree as CASE expression")
    return changed
