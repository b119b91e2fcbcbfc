"""Join elimination (paper §2/§4.1): after projection pushdown removes a
table's features, the join that brought the table in is dead weight.

Sound under FK referential integrity (``cfg.fk_integrity``): an inner FK join
neither drops nor duplicates left rows, so when no surviving operator reads
any right-side column (beyond the key, which the left side already has), the
join is the identity on the left input.
"""

from __future__ import annotations

from ..ir import Plan
from .common import ALL, produced_columns, required_columns


def apply(plan: Plan, catalog, cfg, report) -> bool:
    if not cfg.fk_integrity:
        return False
    changed = False
    again = True
    while again:
        again = False
        produced = produced_columns(plan, catalog)
        req = required_columns(plan, catalog)
        for n in list(plan.topo_ordered_nodes()):
            if n.op != "join" or n.attrs.get("how") != "inner":
                continue
            need = req.get(n.id, set())
            if ALL in need:
                continue
            left, right = n.inputs
            key = n.attrs["on"]
            right_only = produced.get(right, set()) - produced.get(left, set())
            if need & right_only:
                continue
            plan.rewire(n.id, left)
            plan.prune_dead()
            changed = again = True
            report.log("join_elimination",
                       f"dropped join {n.id} (right side unused)")
            break
    return changed
