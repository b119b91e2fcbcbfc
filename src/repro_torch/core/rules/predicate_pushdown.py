"""Standard relational predicate pushdown (paper §2 'standard DB
optimizations').

Moves filters toward scans: below ``attach_column``/``map`` when the predicate
does not reference the computed column (this lets predicates reach the model
and enables predicate-based model pruning), and into the matching side of a
join when the referenced columns live entirely on one side.
"""

from __future__ import annotations

from ...relational.expr import expr_params
from ..ir import Category, Node, Plan
from .common import produced_columns


def apply(plan: Plan, catalog, cfg, report) -> bool:
    changed = False
    moved = True
    while moved:
        moved = False
        produced = produced_columns(plan, catalog)
        for n in list(plan.topo_ordered_nodes()):
            if n.op != "filter":
                continue
            child = plan.node(n.inputs[0])
            refs = n.attrs["predicate"].references()
            if child.op in ("attach_column", "map"):
                made = child.attrs["name"]
                # Param-bearing filters stay *above* attach_column: the SQL
                # frontend deliberately places them after the model chain so
                # the expensive prefix is param-free and result-cacheable
                # (see sql_frontend conjunct routing); pushing them back
                # down would re-poison every cacheable subtree.
                if expr_params(n.attrs["predicate"]):
                    continue
                if made not in refs and len(plan.consumers(child.id)) == 1:
                    # swap: filter moves below child
                    below = child.inputs[0]
                    plan.rewire(n.id, child.id)       # consumers(filter)->child
                    child.inputs[0] = n.id
                    n.inputs[0] = below
                    moved = changed = True
                    report.log("predicate_pushdown",
                               f"pushed {n.id} below {child.op} {child.id}")
                    break
            elif child.op == "join" and len(plan.consumers(child.id)) == 1:
                left, right = child.inputs
                key = child.attrs["on"]
                if refs <= produced.get(left, set()):
                    side, idx = left, 0
                elif refs <= produced.get(right, set()):
                    side, idx = right, 1
                else:
                    continue
                plan.rewire(n.id, child.id)
                child.inputs[idx] = n.id
                n.inputs[0] = side
                moved = changed = True
                report.log("predicate_pushdown",
                           f"pushed {n.id} into join side {idx}")
                break
    return changed
