"""Model/query splitting (paper §2): partition the query on the model's root
predicate so each branch runs a *smaller specialized model*, then union.

The root split of a pruned tree often separates a cheap region from an
expensive one (paper: age<=35 vs age>35 — shares commonalities with model
cascades).  We rewrite

    attach(T, predict(featurize(T), M))

into

    union( attach(filter(T, root_cond),  predict(featurize(.), M_left)),
           attach(filter(T, !root_cond), predict(featurize(.), M_right)) )

where M_left/M_right are ``M`` pruned under the respective constraint.  Each
branch is then independently optimizable (the left branch may drop joins the
right still needs).  Opt-in (``cfg.enable_model_query_splitting``): the union
doubles physical row capacity in the static-shape engine, so it pays off when
the per-branch models are much cheaper or branch execution is routed host-side
(see ``benchmarks/fig2b_clustering.py`` for the routed variant).
"""

from __future__ import annotations

import copy

import numpy as np

from ...relational.expr import Const, UnaryOp
from ..ir import Category, Node, Plan
from .common import feature_exprs, find_predict_chains


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    for chain in find_predict_chains(plan):
        model = chain.predict.attrs["model"]
        if getattr(model, "kind", None) != "decision_tree":
            continue
        if chain.attach is None or chain.predict.attrs.get("split"):
            continue
        tree = model.tree
        if tree.left[0] < 0:
            continue
        feats = feature_exprs(chain.featurize.attrs["featurizers"])
        if feats is None:
            continue
        f, t = int(tree.feature[0]), float(tree.threshold[0])
        left_tree = tree.prune_with_constraints({f: (-np.inf, t)})
        right_tree = tree.prune_with_constraints(
            {f: (float(np.nextafter(t, np.inf)), np.inf)})
        total = tree.n_nodes
        if min(left_tree.n_nodes, right_tree.n_nodes) / total \
                > cfg.split_imbalance:
            continue

        cond = feats[f] <= Const(t)
        name = chain.attach.attrs["name"]
        branches = []
        for branch_cond, branch_tree in ((cond, left_tree),
                                         (UnaryOp("not", cond), right_tree)):
            filt = Node(op="filter", category=Category.RA,
                        inputs=[chain.table_input],
                        attrs={"predicate": branch_cond}, out_kind="table")
            plan.add(filt)
            feat = chain.featurize.copy(id="", inputs=[filt.id])
            plan.add(feat)
            m = copy.copy(model)
            m.tree = branch_tree
            pred = chain.predict.copy(id="", inputs=[feat.id])
            pred.attrs = dict(pred.attrs, model=m, split=True)
            plan.add(pred)
            att = Node(op="attach_column", category=Category.RA,
                       inputs=[filt.id, pred.id], attrs={"name": name},
                       out_kind="table")
            plan.add(att)
            branches.append(att.id)
        union = Node(op="union", category=Category.RA, inputs=branches,
                     attrs={}, out_kind="table")
        plan.add(union)
        plan.rewire(chain.attach.id, union.id)
        plan.prune_dead()
        changed = True
        report.log("model_query_splitting",
                   f"{chain.predict.attrs.get('model_name')}: split on "
                   f"feature {f} <= {t:.3g} "
                   f"({left_tree.n_nodes}/{right_tree.n_nodes} nodes)")
    return changed
