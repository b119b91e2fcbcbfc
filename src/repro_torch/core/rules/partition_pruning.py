"""Zone-map partition pruning (data-skipping, paper §4.1 extended).

After ``predicate_pushdown`` has moved filters onto scans, every scan of a
*partitioned* catalog table is checked against the zone maps collected at
registration (``core/partition.py``): a partition whose per-column
min/max/domain statistics prove that no valid row can satisfy the
conjunctive constraints of the filter chain directly above the scan is
statically skipped.  All-NULL partitions (no valid rows) are skipped
unconditionally.

The surviving partition indices are recorded in the scan node's
``partitions`` attr, which

- makes plan signatures **partition-aware** (the attr participates in
  ``ir.canonical_form``, so a plan pruned to a different partition set is
  a different cached executable);
- feeds the cost model's partition-count-aware row estimates
  (``cost_model.estimate_rows``);
- tells the sharded executor (``serve/sharded.py``) which partitions to
  place on devices.

Soundness: only filters on a single-consumer chain directly above the
scan contribute constraints — every downstream consumer then observes the
scan's rows exclusively through those filters, and a pruned partition's
rows would all carry ``valid=False`` past them.  Selections never widen
the validity mask, so no downstream operator can distinguish "rows
present but invalid" from "rows never scanned" (the bag-semantics
contract the hypothesis property in
``tests/test_partitioned_execution.py`` checks bit-exactly).
"""

from __future__ import annotations

from typing import List

from ...relational.expr import Constraint, extract_constraints
from ..ir import Plan


def _chain_constraints(plan: Plan, scan_id: str) -> List[Constraint]:
    """Constraints from the unbroken single-consumer filter chain above
    ``scan_id``.  A fork (multiple consumers) ends the chain: a sibling
    consumer would see unfiltered rows, so its filters must not prune."""
    out: List[Constraint] = []
    nid = scan_id
    while True:
        consumers = plan.consumers(nid)
        if len(consumers) != 1:
            break
        node = plan.nodes[consumers[0]]
        if node.op != "filter":
            break
        out.extend(extract_constraints(node.attrs["predicate"]))
        nid = node.id
    return out


def apply(plan: Plan, catalog, cfg, report) -> bool:
    get_partitioned = getattr(catalog, "get_partitioned", None)
    if get_partitioned is None:
        return False
    changed = False
    for scan in plan.find("scan"):
        if "partitions" in scan.attrs:
            continue                      # already pruned (fixpoint)
        table = scan.attrs["table"]
        pt = get_partitioned(table)
        if pt is None or pt.n_partitions <= 1:
            continue
        constraints = _chain_constraints(plan, scan.id)
        surviving, pruned = pt.prune(constraints)
        if not pruned:
            continue                      # keep attrs (and signature) stable
        scan.attrs["partitions"] = surviving
        report.partitions[table] = (len(surviving), pt.n_partitions)
        report.log("partition_pruning",
                   f"table {table}: skipped {len(pruned)} of "
                   f"{pt.n_partitions} partitions "
                   f"({len(constraints)} constraints)")
        changed = True
    return changed
