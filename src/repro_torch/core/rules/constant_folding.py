"""Compiler-style constant folding over IR expressions (paper §2, §4.1).

The paper implements constant folding inside ONNX Runtime; here it runs at the
IR level.  Folds
filter/map expressions, drops always-true filters, and collapses CASE
branches whose conditions are statically known (this is what makes the
``pregnant`` constant propagate "inside the NN" in the running example).
"""

from __future__ import annotations

from ...relational.expr import Const, fold_constants
from ..ir import Plan


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    for n in list(plan.topo_ordered_nodes()):
        if n.op == "filter":
            folded = fold_constants(n.attrs["predicate"])
            if repr(folded) != repr(n.attrs["predicate"]):
                n.attrs["predicate"] = folded
                changed = True
                report.log("constant_folding", f"folded predicate in {n.id}")
            if isinstance(folded, Const) and bool(folded.value):
                plan.rewire(n.id, n.inputs[0])
                changed = True
                report.log("constant_folding",
                           f"removed always-true filter {n.id}")
        elif n.op == "map":
            folded = fold_constants(n.attrs["expr"])
            if repr(folded) != repr(n.attrs["expr"]):
                n.attrs["expr"] = folded
                changed = True
                report.log("constant_folding", f"folded map expr in {n.id}")
    return changed
