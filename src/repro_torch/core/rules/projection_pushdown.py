"""Model-projection pushdown — the paper's model-to-data rule (§4.1, Fig 2a).

Zero-weight features (L1-regularized models) and features no tree branch ever
tests are projected out *early*: the featurizers stop computing them, the
featurize node's ``input_columns`` shrink, scans narrow to the surviving
columns, and — downstream of this rule — join elimination can drop entire
joins whose table no longer feeds any feature.

``cfg.lossy_pushdown_tol > 0`` enables the paper's proposed *lossy* variant
(drop small-but-nonzero weights); the report records it so accuracy deltas
can be attributed.
"""

from __future__ import annotations

import numpy as np

from ..ir import Category, Node, Plan
from .common import (ALL, find_predict_chains, input_columns_of,
                     required_columns, restrict_featurizers)


def _keep_set(model, n_features: int, tol: float):
    kind = getattr(model, "kind", None)
    if kind in ("linear_regression", "logistic_regression"):
        w = np.asarray(model.weights)
        return set(int(i) for i in np.nonzero(np.abs(w) > max(tol, 1e-12))[0])
    if kind == "decision_tree":
        return set(int(i) for i in model.tree.used_features())
    if kind in ("random_forest", "gbt"):
        used = set()
        for t in model.trees:
            used |= set(int(i) for i in t.used_features())
        return used
    if kind == "mlp":
        w0 = np.asarray(model.params[0]["w"])
        norms = np.abs(w0).sum(axis=1)
        thr = tol if tol > 0 else 1e-12
        return set(int(i) for i in np.nonzero(norms > thr)[0])
    return None


def _restrict_model(model, kept_old):
    import copy
    kind = getattr(model, "kind", None)
    remap = {old: new for new, old in enumerate(kept_old)}
    if kind in ("linear_regression", "logistic_regression"):
        return model.restrict_features(np.asarray(kept_old, np.int64))
    if kind == "mlp":
        return model.restrict_features(np.asarray(kept_old, np.int64))
    if kind in ("decision_tree", "random_forest", "gbt"):
        def remap_tree(t):
            feat = t.feature.copy()
            internal = ~t.is_leaf()
            feat[internal] = np.asarray(
                [remap[int(f)] for f in t.feature[internal]], np.int32)
            import dataclasses
            return dataclasses.replace(t, feature=feat,
                                       n_features=len(kept_old))
        clone = copy.copy(model)
        if kind == "decision_tree":
            clone.tree = remap_tree(model.tree)
        else:
            clone.trees = [remap_tree(t) for t in model.trees]
        return clone
    return None


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    for chain in find_predict_chains(plan):
        featurizers = chain.featurize.attrs["featurizers"]
        n_features = sum(f.mapping().n_features for f in featurizers)
        model = chain.predict.attrs["model"]
        keep = _keep_set(model, n_features, cfg.lossy_pushdown_tol)
        if keep is None or len(keep) >= n_features:
            continue
        new_feats, index_map = restrict_featurizers(featurizers, keep)
        kept_old = sorted(index_map, key=lambda o: index_map[o])
        if len(kept_old) >= n_features:
            continue
        new_model = _restrict_model(model, kept_old)
        if new_model is None:
            continue
        before_cols = set(chain.featurize.attrs["input_columns"])
        chain.featurize.attrs["featurizers"] = new_feats
        chain.featurize.attrs["input_columns"] = input_columns_of(new_feats)
        chain.predict.attrs["model"] = new_model
        after_cols = set(chain.featurize.attrs["input_columns"])
        changed = True
        lossy = " (lossy)" if cfg.lossy_pushdown_tol > 0 else ""
        report.log("projection_pushdown",
                   f"{chain.predict.attrs.get('model_name')}: "
                   f"{n_features - len(kept_old)}/{n_features} features "
                   f"dropped{lossy}; columns {sorted(before_cols - after_cols)}"
                   f" no longer read")

    # Narrow scans to the columns actually demanded downstream.
    req = required_columns(plan, catalog)
    for n in list(plan.topo_ordered_nodes()):
        if n.op != "scan" or n.attrs.get("projected"):
            continue
        need = req.get(n.id, set())
        if ALL in need or not need:
            continue
        try:
            have = set(catalog.get_table(n.attrs["table"]).names)
        except Exception:
            continue
        cols = sorted(need & have)
        if cols and set(cols) != have:
            n.attrs["projected"] = True
            proj = Node(op="project", category=Category.RA,
                        inputs=[n.id], attrs={"columns": cols},
                        out_kind="table")
            plan.add(proj)
            plan.rewire(n.id, proj.id)
            # rewire points scan's consumers at proj; restore proj's own input
            proj.inputs = [n.id]
            changed = True
            report.log("projection_pushdown",
                       f"scan {n.attrs['table']}: project to {cols}")
    return changed
