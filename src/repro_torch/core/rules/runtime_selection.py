"""Runtime selection (paper §4.3/§5): decide where each operator executes.

Native (in-process, inside the compiled plan) whenever the model kind is
supported; out-of-process for pipelines flagged ``external`` (the
sp_execute_external_script path); containerized for everything else.  The
paper's coverage ladder, verbatim — with one honesty amendment: tree-kind
models are only confirmed "native" together with a *measured* inference
strategy.  BENCH_6 showed the translated (GEMM) form losing 14-20x to
traversal on CPU while the rules kept translating; now the node carries the
cost-model crossover's verdict (``tree_strategy`` attr, set by
``nn_translation`` or computed here when that rule is disabled) so a forest
that stays ``predict_model`` does so because traversal measured fastest, not
because a heuristic said forests are always native food.
"""

from __future__ import annotations

from ..ir import Plan

_NATIVE_KINDS = {"decision_tree", "random_forest", "gbt",
                 "linear_regression", "logistic_regression", "mlp"}
_TREE_KINDS = {"decision_tree", "random_forest", "gbt"}


def _measured_strategy(n, plan, catalog, cfg, report) -> None:
    """Annotate a surviving tree-kind predict_model with the measured
    crossover verdict.  ``nn_translation`` normally does this (and rewrites
    the node when GEMM/CUDA wins); when it is disabled or skipped the
    annotation still lands here so the plan records an honest decision."""
    if n.attrs.get("tree_strategy") is not None:
        return
    try:
        from ..cost_model import choose_tree_strategy, strategy_rows
        rows = strategy_rows(plan, catalog)
        n_rows = rows.get(n.inputs[0], 1e6) if n.inputs else 1e6
        model = n.attrs["model"]
        t0 = model.tree if model.kind == "decision_tree" else model.trees[0]
        n_feat = int(t0.n_features)
        strategy, costs = choose_tree_strategy(model, n_rows, n_feat,
                                               catalog=catalog)
    except Exception:      # calibration must never break optimization
        return
    n.attrs["tree_strategy"] = strategy
    if strategy != "traversal":
        report.log("runtime_selection",
                   f"{n.id}: native traversal kept but measured crossover "
                   f"prefers {strategy} (enable nn_translation to use it)")


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    for n in plan.topo_ordered_nodes():
        if n.op != "predict_model":
            continue
        flavor = n.attrs.get("flavor", "repro.native")
        kind = getattr(n.attrs.get("model"), "kind", None)
        want = "native"
        if flavor == "external" or (kind not in _NATIVE_KINDS
                                    and flavor != "container"):
            want = "external"
        if flavor == "container":
            want = "container"
        if kind in _NATIVE_KINDS and flavor == "repro.native":
            want = "native"
            if kind in _TREE_KINDS:
                _measured_strategy(n, plan, catalog, cfg, report)
        if n.runtime != want:
            n.runtime = want
            changed = True
            report.log("runtime_selection", f"{n.id} -> {want}")
    return changed
