"""NN translation: classical ML operators -> linear algebra (paper §4.2,
Fig 2d; Hummingbird GEMM strategy).

Trees/forests/GBTs become the batched tree-GEMM operator (executed by the
hand-written CUDA kernel under strategy "cuda", by ``torch.matmul`` under
"gemm"); linear models become
``matmul_bias`` (+ sigmoid/threshold); MLPs become their literal layer chain.
After this rule the ML half of the plan contains only LA nodes — the form in
which an accelerator (and the paper's ONNX Runtime) wants to execute it.
"""

from __future__ import annotations

import numpy as np

from ..ir import Category, Node, Plan
from .common import find_predict_chains

# I and L padding of the "cuda" strategy's ensemble.  The kernel takes any
# size; 128 keeps the row tile's loops free of remainders.
CUDA_PAD = 128


def _translate_trees(plan, chain, cfg, report,
                     strategy: str = "gemm") -> bool:
    from ...ml.hummingbird import ensemble_to_gemm
    model = chain.predict.attrs["model"]
    kind = model.kind
    task = chain.predict.attrs.get("task", "classification")
    proba = chain.predict.attrs.get("proba", False)
    if kind == "decision_tree":
        trees, average, bias, scale = [model.tree], True, 0.0, 1.0
    elif kind == "random_forest":
        trees, average, bias, scale = model.trees, True, 0.0, 1.0
    else:  # gbt
        trees, average = model.trees, False
        bias, scale = model.base, model.learning_rate
        task = "regression"
    # The CUDA kernel's strategy pads to CUDA_PAD; the gather-gated dense
    # strategy has no alignment requirement and wastes flops on padding.
    pad = CUDA_PAD if strategy == "cuda" else cfg.gemm_pad_to
    ens = ensemble_to_gemm(trees, pad_to=pad, average=average)
    if scale != 1.0:
        ens.e = (ens.e * scale).astype(np.float32)
    node = Node(op="tree_gemm", category=Category.LA,
                inputs=[chain.featurize.id],
                attrs={"ensemble": ens, "task": task, "proba": proba,
                       "bias": bias, "strategy": strategy,
                       "model_name": chain.predict.attrs.get("model_name")},
                out_kind="matrix")
    plan.add(node)
    plan.rewire(chain.predict.id, node.id)
    plan.prune_dead()
    report.log("nn_translation",
               f"{chain.predict.attrs.get('model_name')}: {kind} -> "
               f"tree_gemm/{strategy} [{ens.a.shape[0]}x{ens.a.shape[2]}i/"
               f"{ens.c.shape[2]}l pad {pad}]")
    return True


def _translate_linear(plan, chain, report) -> bool:
    model = chain.predict.attrs["model"]
    task = chain.predict.attrs.get("task", "classification")
    proba = chain.predict.attrs.get("proba", False)
    w = np.asarray(model.weights, np.float32)[:, None]
    b = np.asarray([model.bias], np.float32)
    mm = Node(op="matmul_bias", category=Category.LA,
              inputs=[chain.featurize.id],
              attrs={"weights": w, "bias": b}, out_kind="matrix")
    plan.add(mm)
    out = Node(op="select_column", category=Category.LA, inputs=[mm.id],
               attrs={"index": 0}, out_kind="matrix")
    plan.add(out)
    last = out.id
    if model.kind == "logistic_regression":
        if proba:
            sig = Node(op="sigmoid", category=Category.LA, inputs=[last],
                       attrs={}, out_kind="matrix")
            plan.add(sig)
            last = sig.id
        else:
            thr = Node(op="threshold", category=Category.LA, inputs=[last],
                       attrs={"value": 0.0}, out_kind="matrix")
            plan.add(thr)
            last = thr.id
    plan.rewire(chain.predict.id, last)
    plan.prune_dead()
    report.log("nn_translation",
               f"{chain.predict.attrs.get('model_name')}: {model.kind} -> "
               f"matmul_bias({w.shape[0]}x1)")
    return True


def _translate_mlp(plan, chain, report) -> bool:
    model = chain.predict.attrs["model"]
    task = chain.predict.attrs.get("task", "classification")
    proba = chain.predict.attrs.get("proba", False)
    last = chain.featurize.id
    for i, layer in enumerate(model.params):
        mm = Node(op="matmul_bias", category=Category.LA, inputs=[last],
                  attrs={"weights": np.asarray(layer["w"], np.float32),
                         "bias": np.asarray(layer["b"], np.float32)},
                  out_kind="matrix")
        plan.add(mm)
        last = mm.id
        if i < len(model.params) - 1:
            act = Node(op="relu", category=Category.LA, inputs=[last],
                       attrs={}, out_kind="matrix")
            plan.add(act)
            last = act.id
    if task == "classification":
        if proba:
            sm = Node(op="softmax", category=Category.LA, inputs=[last],
                      attrs={}, out_kind="matrix")
            plan.add(sm)
            sel = Node(op="select_column", category=Category.LA,
                       inputs=[sm.id], attrs={"index": 1}, out_kind="matrix")
            plan.add(sel)
            last = sel.id
        else:
            am = Node(op="argmax", category=Category.LA, inputs=[last],
                      attrs={}, out_kind="matrix")
            plan.add(am)
            last = am.id
    else:
        sel = Node(op="select_column", category=Category.LA, inputs=[last],
                   attrs={"index": 0}, out_kind="matrix")
        plan.add(sel)
        last = sel.id
    plan.rewire(chain.predict.id, last)
    plan.prune_dead()
    report.log("nn_translation",
               f"{chain.predict.attrs.get('model_name')}: mlp -> "
               f"{len(model.params)} matmul_bias layers")
    return True


_TREE_KINDS = ("decision_tree", "random_forest", "gbt")


def _pick_tree_strategy(plan, chain, model, catalog, cfg, report,
                        rows) -> str:
    """traversal / gemm / cuda for this chain.

    Precedence: an explicit ``cfg.tree_strategy`` wins; then the single-tree
    heuristic knob (``nn_translate_single_trees``: "always" forces the dense
    form, "never" keeps traversal); otherwise the *measured* cost-model
    crossover (``choose_tree_strategy``, calibrated once per process and
    cached in the ModelStore) decides per (n_rows, n_trees, depth, backend).
    """
    forced = getattr(cfg, "tree_strategy", "auto")
    if forced != "auto":
        return forced
    if model.kind == "decision_tree":
        mode = getattr(cfg, "nn_translate_single_trees", "auto")
        if mode == "always":
            return "gemm"
        if mode == "never":
            return "traversal"
    from ..cost_model import choose_tree_strategy, estimate_rows
    if not rows:
        rows.update(estimate_rows(plan, catalog))
    n_feat = sum(f.mapping().n_features
                 for f in chain.featurize.attrs["featurizers"])
    n_rows = rows.get(chain.table_input, 1e6)
    strategy, costs = choose_tree_strategy(model, n_rows, n_feat,
                                           catalog=catalog)
    pretty = ", ".join(f"{k} {v * 1e6:.0f}us" for k, v in
                       sorted(costs.items(), key=lambda kv: kv[1]))
    report.log("tree_strategy",
               f"{chain.predict.attrs.get('model_name')}: {strategy} "
               f"(est rows {n_rows:.3g}; {pretty})")
    return strategy


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    rows = {}
    for chain in find_predict_chains(plan):
        if chain.predict.runtime != "native":
            continue
        model = chain.predict.attrs["model"]
        kind = getattr(model, "kind", None)
        if kind in _TREE_KINDS:
            strategy = _pick_tree_strategy(plan, chain, model, catalog, cfg,
                                           report, rows)
            if strategy == "traversal":
                # Honest non-translation: the measured crossover says the
                # native traversal is the fastest form here.  Record the
                # decision on the node so runtime_selection (and plan
                # signatures) see a deliberate choice, not a skipped rule.
                if chain.predict.attrs.get("tree_strategy") != "traversal":
                    chain.predict.attrs["tree_strategy"] = "traversal"
                    changed = True
                continue
            changed |= _translate_trees(plan, chain, cfg, report, strategy)
        elif kind in ("linear_regression", "logistic_regression"):
            changed |= _translate_linear(plan, chain, report)
        elif kind == "mlp":
            changed |= _translate_mlp(plan, chain, report)
    return changed
