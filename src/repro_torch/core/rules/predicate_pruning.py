"""Predicate-based model pruning — the paper's flagship data-to-model rule
(§4.1).

For every model invocation we collect the column constraints that *provably*
hold for all rows reaching it (WHERE conjuncts on the path + optionally
registered table statistics — the 'data properties' variant), translate them
into feature-space bounds through the featurizers, and then:

- **trees / forests / GBTs**: structurally prune unreachable branches
  (paper: −29 % on the hospital tree);
- **linear / logistic models**: features pinned to a constant fold into the
  bias and are dropped — for one-hot groups under an equality predicate this
  removes the whole group minus nothing (all features of the group become
  constants), the paper's ~2.1× one-hot LR case;
- **MLPs**: constant features fold into the first layer's bias (NN
  constant folding, as ONNX Runtime does it).
"""

from __future__ import annotations

import numpy as np

from ..ir import Plan
from .common import (constant_features, feature_bounds, find_predict_chains,
                     input_columns_of, restrict_featurizers,
                     upstream_constraints)


def _prune_tree_model(model, bounds):
    import copy
    kind = model.kind
    if kind == "decision_tree":
        before = model.tree.n_nodes
        pruned = model.tree.prune_with_constraints(bounds)
        if pruned.n_nodes >= before:
            return None, 0
        clone = copy.copy(model)
        clone.tree = pruned
        return clone, before - pruned.n_nodes
    if kind in ("random_forest", "gbt"):
        before = sum(t.n_nodes for t in model.trees)
        new_trees = [t.prune_with_constraints(bounds) for t in model.trees]
        after = sum(t.n_nodes for t in new_trees)
        if after >= before:
            return None, 0
        clone = copy.copy(model)
        clone.trees = new_trees
        return clone, before - after
    return None, 0


def _fold_linear_constants(model, consts, featurizers):
    """Fold constant features into the bias; drop them from model+featurizers.

    Returns (new_model, new_featurizers, n_dropped) or None."""
    import copy
    w = np.asarray(model.weights)
    drop = sorted(consts)
    if not drop:
        return None
    bias_delta = float(sum(w[i] * consts[i] for i in drop))
    keep = [i for i in range(w.shape[0]) if i not in consts]
    new_feats, index_map = restrict_featurizers(featurizers, set(keep))
    # restrict_featurizers may keep un-shrinkable blocks; honor its map
    kept_old = sorted(index_map, key=lambda o: index_map[o])
    clone = copy.copy(model)
    clone.weights = w[kept_old].astype(np.float32)
    clone.bias = model.bias + bias_delta
    if model.feature_names:
        clone.feature_names = [model.feature_names[i] for i in kept_old]
    return clone, new_feats, w.shape[0] - len(kept_old)


def _fold_mlp_constants(model, consts, featurizers):
    import copy
    w0 = np.asarray(model.params[0]["w"])       # [d_in, h]
    b0 = np.asarray(model.params[0]["b"])
    drop = sorted(consts)
    if not drop:
        return None
    bias_delta = sum(w0[i] * consts[i] for i in drop)
    keep = [i for i in range(w0.shape[0]) if i not in consts]
    new_feats, index_map = restrict_featurizers(featurizers, set(keep))
    kept_old = sorted(index_map, key=lambda o: index_map[o])
    clone = copy.copy(model)
    params = [dict(p) for p in model.params]
    params[0] = {"w": np.asarray(w0[kept_old]),
                 "b": np.asarray(b0 + bias_delta)}
    clone.params = params
    return clone, new_feats, w0.shape[0] - len(kept_old)


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    for chain in find_predict_chains(plan):
        if chain.predict.attrs.get("pruned"):
            continue
        constraints = upstream_constraints(
            plan, chain.table_input, catalog, use_stats=cfg.enable_stats_pruning)
        if not constraints:
            continue
        featurizers = chain.featurize.attrs["featurizers"]
        bounds = feature_bounds(featurizers, constraints)
        if not bounds:
            continue
        model = chain.predict.attrs["model"]
        kind = getattr(model, "kind", None)

        if kind in ("decision_tree", "random_forest", "gbt"):
            new_model, removed = _prune_tree_model(model, bounds)
            if new_model is not None:
                chain.predict.attrs["model"] = new_model
                chain.predict.attrs["pruned"] = True
                changed = True
                report.log("predicate_model_pruning",
                           f"{chain.predict.attrs.get('model_name')}: "
                           f"pruned {removed} tree nodes")
        elif kind in ("linear_regression", "logistic_regression"):
            res = _fold_linear_constants(model, constant_features(bounds),
                                         featurizers)
            if res is not None:
                new_model, new_feats, dropped = res
                if dropped > 0:
                    chain.predict.attrs["model"] = new_model
                    chain.predict.attrs["pruned"] = True
                    chain.featurize.attrs["featurizers"] = new_feats
                    chain.featurize.attrs["input_columns"] = \
                        input_columns_of(new_feats)
                    changed = True
                    report.log("predicate_model_pruning",
                               f"{chain.predict.attrs.get('model_name')}: "
                               f"folded {dropped} constant features into bias")
        elif kind == "mlp":
            res = _fold_mlp_constants(model, constant_features(bounds),
                                      featurizers)
            if res is not None:
                new_model, new_feats, dropped = res
                if dropped > 0:
                    chain.predict.attrs["model"] = new_model
                    chain.predict.attrs["pruned"] = True
                    chain.featurize.attrs["featurizers"] = new_feats
                    chain.featurize.attrs["input_columns"] = \
                        input_columns_of(new_feats)
                    changed = True
                    report.log("predicate_model_pruning",
                               f"{chain.predict.attrs.get('model_name')}: "
                               f"NN constant-folded {dropped} features")
    return changed
