"""Common-subplan elimination across model invocations (beyond-paper; the
paper names multi-query optimization as future work in §1/§6).

Two invocations that share work — e.g. ``PREDICT(MODEL='m')`` in the SELECT
list and ``PREDICT_PROBA(MODEL='m')`` in the WHERE clause — each build their
own featurize (and sometimes predict) chain.  Merging happens in two layers:

- **semantic merges** — featurize nodes whose effective input matches after
  skipping attach_column/map nodes that add columns the featurizer never
  reads; predict nodes with the same (input, model, task, proba).
- **structural CSE** — any two deterministic nodes whose *subtree
  signatures* (``ir.subtree_signatures``) coincide compute bit-identical
  results and merge.  Signatures hash model/featurizer attrs by content
  (``model_store.content_fingerprint``), so two distinct-but-byte-identical
  model objects still merge — stronger than the ``id()``-keyed semantic
  pass.  UDF subtrees are excluded (``ir.is_deterministic_subtree``).

The same subtree-signature machinery identifies shared sub-plans *across*
queries in the serving layer's materialized result cache
(``serve.prediction_service``); this rule is the within-plan instance.
"""

from __future__ import annotations

from ..ir import Plan, is_deterministic_subtree, subtree_signatures


def _effective_input(plan: Plan, nid: str, needed_cols) -> str:
    """Walk up through attach_column/map nodes whose added column the
    featurizer never reads — they don't change the feature matrix."""
    while True:
        n = plan.node(nid)
        if n.op in ("attach_column", "map") \
                and n.attrs.get("name") not in needed_cols:
            nid = n.inputs[0]
            continue
        return nid


def _featurize_key(plan, n):
    src = _effective_input(plan, n.inputs[0],
                           set(n.attrs.get("input_columns", ())))
    return ("featurize", src, n.attrs.get("pipeline_name"),
            tuple(id(f) for f in n.attrs["featurizers"]))


def _predict_key(n):
    return ("predict", tuple(n.inputs), id(n.attrs.get("model")),
            n.attrs.get("proba"), n.attrs.get("task"), n.runtime)


def _semantic_pass(plan: Plan, report) -> bool:
    changed = False
    again = True
    while again:
        again = False
        seen = {}
        for n in plan.topo_ordered_nodes():
            if n.op == "featurize":
                key = _featurize_key(plan, n)
            elif n.op == "predict_model":
                key = _predict_key(n)
            else:
                continue
            if key in seen and seen[key] != n.id:
                plan.rewire(n.id, seen[key])
                plan.prune_dead()
                report.log("subplan_dedup",
                           f"merged duplicate {n.op} {n.id} -> {seen[key]}")
                changed = again = True
                break
            seen[key] = n.id
    return changed


def _structural_cse(plan: Plan, report) -> bool:
    """Merge any two deterministic nodes with identical subtree signatures
    (they compute bit-identical results by construction).

    One signature sweep suffices: rewiring a duplicate onto its keeper
    never changes any other node's *structural* signature (the keeper's
    subtree is canonically identical to the one it replaced), so every
    duplicate group found in the initial sweep can be merged in place.
    """
    if plan.output is None:
        return False
    changed = False
    keeper = {}
    for nid, sig in subtree_signatures(plan).items():   # post-order
        first = keeper.setdefault(sig, nid)
        if first == nid:
            continue
        if not is_deterministic_subtree(plan, nid):
            continue
        plan.rewire(nid, first)
        report.log("subplan_dedup",
                   f"merged structurally identical "
                   f"{plan.nodes[first].op} subtree {nid} -> {first}")
        changed = True
    if changed:
        plan.prune_dead()
    return changed


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = _semantic_pass(plan, report)
    changed |= _structural_cse(plan, report)
    return changed
