"""Distributed-plan rewriting: partition-wise joins + two-phase aggregation.

After ``partition_pruning`` has annotated scans of partitioned tables, this
rule finds the plan shapes that can execute *partition-parallel* beyond the
row-local single-scan case PR 4 shipped, and records the local/global split
in plan attrs:

- a ``join`` whose two input subtrees are partition-local chains down to
  scans of **co-partitioned** tables (``partition.compatible_partitioning``:
  both range-partitioned on the join key, equal partition counts, zone-map
  key ranges pairwise disjoint across different indices) is marked
  ``partition_wise``: joining aligned partition pairs locally and
  concatenating in partition order equals the whole-table join on valid
  rows — a valid left key can only find its (unique) right match inside
  the same-indexed right partition;

- a ``join`` whose sides are both partition-local chains with the join
  key intact but whose tables are **not** co-partitioned is marked
  ``exchange``: a hash-repartition shuffle on the join key restores the
  partition-wise argument — every key value lands in exactly one hash
  bucket on both sides, so bucket-local joins scattered back to the
  anchor's original row order equal the whole-table join on valid rows,
  for *any* bucket count (``serve/exchange.py`` implements the shuffle);

- every ``group_agg`` over a partition-local subtree whose aggregate
  functions all have mergeable state (``ops.COMBINABLE_AGGS``: sum, count,
  min, max, mean = sum (+) count) is marked ``two_phase``: the serving
  layer compiles the subtree plus a ``partial_agg`` head as the per-morsel
  *local* program and folds the per-morsel states host-side
  (``ops.combine_partials``) before running whatever sits above the
  aggregations (the *global* stage) on the tiny combined tables.  Plans
  with several sibling aggregations over partition-local subtrees split
  each independently; the split is all-or-nothing — if any live
  ``group_agg`` is ineligible (e.g. an aggregation *of* an aggregation,
  whose input is not partition-local), none is marked.

The marks live in node attrs, so they participate in
``ir.canonical_form``: a plan rewritten for distribution is a different
structural signature from its whole-table twin, which keeps the executable
caches and ``ir.sharded_signature`` honest.  The rule only *marks*;
``serve/prediction_service.py`` re-derives locality on the final optimized
plan (later rules may rewrite model ops — all into row-local LA forms —
or eliminate a marked join entirely) and builds the actual split.

**Partition-locality** (:func:`local_anchor`): an op is partition-local
when running it per aligned partition group and concatenating outputs in
partition order equals running it whole.  Row-local ops (``ir.
ROW_LOCAL_OPS``) are trivially so; a co-partitioned join is so by the
argument above; its *anchor* — the table whose partition row counts shape
each morsel's output — is the left (probe) side's anchor, because FK-join
output rows are positionally the left rows.  A non-co-partitioned equi-join
is *bucket-local after an exchange*: the analysis records the join id that
needs the shuffle, and everything above it stays local with respect to hash
buckets instead of catalog partitions.  At most one exchange per chain —
after the shuffle the catalog zone maps no longer describe the row
placement, so a second join (even a nominally co-partitioned one) cannot
stack on top.  Everything else (order_by, limit, union) is not local.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

from ...relational.ops import COMBINABLE_AGGS
from ..ir import Plan, ROW_LOCAL_OPS, subtree_nodes
from ..partition import compatible_partitioning

__all__ = ["apply", "local_anchor", "local_info", "two_phase_candidate",
           "two_phase_candidates"]


# Ops that may appear in the *global* stage above two-phase aggregations:
# they run host-side over the combined tables, so anything goes except ops
# that would pull in additional plan inputs of their own.  Any table leaf
# reachable in the global region is a scan/materialized and is excluded,
# so a join/union surviving there can only consume candidate aggregation
# outputs — which the global stage owns.
_GLOBAL_STAGE_EXCLUDED = frozenset({
    "scan", "materialized", "partial_agg",
})

# (anchor table, intact column names, exchange join id or None) — see
# local_anchor / local_info
_Local = Tuple[str, FrozenSet[str], Optional[str]]


def _visit_local(plan: Plan, nid: str, get_partitioned,
                 memo: Dict[str, Optional[_Local]]) -> Optional[_Local]:
    """Partition-locality analysis.  Besides the anchor, tracks which
    column names of the node's output still hold the anchor-side scan's
    values *verbatim* ("intact"): a join key is only trustworthy for the
    co-partitioning argument if it is intact — a ``rename``/``map``/
    ``attach_column`` between the scan and the join can bind different
    values under the partition key's name, and the zone maps say nothing
    about those.  Filters only narrow validity, projections only drop
    columns; any op that (re)binds a name evicts it from the intact set,
    and a rename evicts both ends (the value moved *and* the name was
    taken)."""
    if nid in memo:
        return memo[nid]
    n = plan.nodes[nid]
    out: Optional[_Local] = None
    if n.op == "scan":
        pt = get_partitioned(n.attrs["table"])
        if pt is not None:
            out = (n.attrs["table"], frozenset(pt.table.names), None)
    elif n.op == "join":
        left = _visit_local(plan, n.inputs[0], get_partitioned, memo)
        right = _visit_local(plan, n.inputs[1], get_partitioned, memo)
        on = n.attrs["on"]
        if left is not None and right is not None \
                and n.attrs.get("how", "inner") in ("inner", "left_mark") \
                and on in left[1] and on in right[1] \
                and left[2] is None and right[2] is None:
            if compatible_partitioning(get_partitioned(left[0]),
                                       get_partitioned(right[0]), on):
                # output rows follow the left side; left columns survive
                # the join unrenamed (colliding right names get a suffix)
                out = (left[0], left[1], None)
            else:
                # not co-partitioned: a hash-repartition exchange on the
                # (intact) join key restores the argument — every key
                # value hashes to exactly one bucket on both sides, so
                # bucket-local joins scattered back to anchor row order
                # equal the whole-table join on valid rows, for any
                # bucket count.  Recording the join id makes everything
                # above bucket-local rather than partition-local.
                out = (left[0], left[1], n.id)
    elif n.op in ROW_LOCAL_OPS and n.inputs:
        ins = [_visit_local(plan, i, get_partitioned, memo)
               for i in n.inputs]
        anchors = {v[0] for v in ins if v is not None}
        if None not in ins and len(anchors) == 1 \
                and len({v[2] for v in ins}) == 1:
            intact = ins[0][1]
            if n.op == "project":
                intact = intact & frozenset(n.attrs["columns"])
            elif n.op == "rename":
                mapping = n.attrs["mapping"]
                involved = set(mapping) | set(mapping.values())
                intact = intact - involved
            elif n.op in ("map", "attach_column"):
                intact = intact - {n.attrs["name"]}
            elif n.out_kind != "table":
                intact = frozenset()     # matrices carry no join columns
            out = (next(iter(anchors)), intact, ins[0][2])
    memo[nid] = out
    return out


def local_info(plan: Plan, nid: str, catalog,
               _memo: Optional[Dict[str, Optional[_Local]]] = None
               ) -> Optional[_Local]:
    """Full locality triple ``(anchor table, intact columns, exchange join
    id or None)`` for the subtree rooted at ``nid``, or ``None`` when the
    subtree cannot run partition- (or bucket-) parallel at all.  A
    non-``None`` third element names the single join in the subtree that
    needs a hash-repartition exchange before the rest is local."""
    get_partitioned = getattr(catalog, "get_partitioned", None)
    if get_partitioned is None:
        return None
    memo: Dict[str, Optional[_Local]] = {} if _memo is None else _memo
    return _visit_local(plan, nid, get_partitioned, memo)


def local_anchor(plan: Plan, nid: str, catalog,
                 _memo: Optional[Dict[str, Optional[_Local]]] = None
                 ) -> Optional[str]:
    """Anchor table name if the subtree rooted at ``nid`` is
    partition-local *without* an exchange, else ``None``.  The anchor is
    the partitioned catalog table whose partitions drive morsel
    placement — every scan in a local subtree is fed aligned slices of
    its own table's partitions, and output rows per morsel follow the
    anchor's rows.  Subtrees that are local only after a shuffle report
    via :func:`local_info` instead."""
    found = local_info(plan, nid, catalog, _memo)
    return found[0] if found is not None and found[2] is None else None


def two_phase_candidates(plan: Plan, catalog) -> List[str]:
    """Node ids (in topological order) of every ``group_agg`` eligible
    for a local/global split, or ``[]``.  Eligible: all aggregate
    functions combinable and the input subtree partition-local (exchange
    joins included — hash buckets partition the rows just as catalog
    partitions do, so per-bucket partials fold the same way).  The split
    is all-or-nothing: every live ``group_agg`` must be a candidate and
    the global region (everything outside the candidate subtrees) must be
    free of further plan inputs, so the global stage stays a pure
    function of the combined tables."""
    if plan.output is None:
        return []
    if getattr(catalog, "get_partitioned", None) is None:
        return []
    order = subtree_nodes(plan, plan.output)
    live = set(order)
    memo: Dict[str, Optional[_Local]] = {}
    cands: List[str] = []
    for nid in order:
        n = plan.nodes[nid]
        if n.op != "group_agg":
            continue
        if not all(fn in COMBINABLE_AGGS
                   for fn, _col in n.attrs["aggs"].values()):
            return []
        if local_info(plan, n.inputs[0], catalog, memo) is None:
            return []
        cands.append(nid)
    if not cands:
        return []
    below: set = set()
    for nid in cands:
        below |= set(subtree_nodes(plan, nid))
    roots = set(cands)
    for nid in live - below:
        if plan.nodes[nid].op in _GLOBAL_STAGE_EXCLUDED:
            return []
        # the global stage may consume candidate *outputs* only: an edge
        # into the interior of a candidate subtree (e.g. a deduped scan
        # shared between a local subtree and the region above the agg)
        # would make the residual read per-row data the combined tables
        # no longer carry
        if any(i in below and i not in roots
               for i in plan.nodes[nid].inputs):
            return []
    return cands


def two_phase_candidate(plan: Plan, catalog) -> Optional[str]:
    """Back-compat shim: the single eligible ``group_agg`` when the plan
    has exactly one candidate, else ``None``."""
    cands = two_phase_candidates(plan, catalog)
    return cands[0] if len(cands) == 1 else None


def apply(plan: Plan, catalog, cfg, report) -> bool:
    get_partitioned = getattr(catalog, "get_partitioned", None)
    if get_partitioned is None:
        return False
    allow_exchange = getattr(cfg, "enable_exchange", True)
    changed = False
    memo: Dict[str, Optional[_Local]] = {}
    for join in plan.find("join"):
        if "partition_wise" in join.attrs or "exchange" in join.attrs:
            continue                      # already marked (fixpoint)
        found = _visit_local(plan, join.id, get_partitioned, memo)
        if found is None:
            continue
        if found[2] is None:
            join.attrs["partition_wise"] = True
            report.log("distributed_plan",
                       f"join on {join.attrs['on']!r}: co-partitioned "
                       f"sides, rewriting to per-partition local joins")
            changed = True
        elif found[2] == join.id and allow_exchange:
            join.attrs["exchange"] = True
            report.log("distributed_plan",
                       f"join on {join.attrs['on']!r}: sides not "
                       f"co-partitioned, rewriting to hash-repartition "
                       f"exchange + per-bucket local joins")
            changed = True
    for gid in two_phase_candidates(plan, catalog):
        g = plan.nodes[gid]
        if "two_phase" in g.attrs:
            continue
        g.attrs["two_phase"] = True
        fns = sorted({fn for fn, _ in g.attrs["aggs"].values()})
        report.log("distributed_plan",
                   f"group_agg key={g.attrs.get('key')!r} ({fns}): split "
                   f"into per-morsel partial aggregates + combine stage")
        changed = True
    return changed
