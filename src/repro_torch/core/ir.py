"""Raven's unified intermediate representation (paper §3.1).

One DAG holds *both* halves of an inference query.  Operator categories map
directly onto the paper's taxonomy:

- **RA** — relational algebra: ``scan, filter, project, map, join, group_agg,
  order_by, limit, union``.
- **LA** — linear algebra: ``matmul, add, mul, compare_le, sigmoid, relu,
  softmax, argmax, tree_gemm, concat_features``.
- **MLD** — classical-ML / featurizers: ``featurize, predict_model``.
- **UDF** — opaque host code the static analyzer could not translate.

Nodes are immutable-ish records in a ``Plan``; rules rewrite by building
replacement nodes and calling :meth:`Plan.replace`.  Node outputs are either a
``Table`` (RA) or a feature matrix (LA/MLD); ``Node.out_kind`` records which,
so the optimizer can type-check rewrites.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import (Any, Callable, Dict, FrozenSet, Iterable, List, Optional,
                    Sequence, Set, Tuple)

__all__ = ["Category", "Node", "Plan", "canonical_form", "plan_signature",
           "subtree_signatures", "subtree_nodes", "is_deterministic_subtree",
           "bucketed_signature", "sharded_signature", "ROW_LOCAL_OPS",
           "plan_params"]


class Category:
    RA = "RA"
    LA = "LA"
    MLD = "MLD"
    UDF = "UDF"


# Ops whose output rows correspond 1:1 (positionally) to their input rows —
# the precondition for chunked execution, request stacking, and the
# partition-local side of distributed plans.  Joins, aggregation, ordering,
# limits and unions break the correspondence; UDFs are excluded
# conservatively (a host callback may inspect the whole batch).  Shared by
# the serving layer and the ``distributed_plan`` rule so the two notions of
# "row-local" can never drift apart.
ROW_LOCAL_OPS = frozenset({
    "scan", "filter", "project", "rename", "map", "attach_column",
    "featurize", "gather_features", "predict_model", "affine", "matmul_bias",
    "sigmoid", "relu", "softmax", "argmax", "select_column", "threshold",
    "tree_gemm", "constant_vector",
})


_ids = itertools.count()


def _fresh_id(prefix: str) -> str:
    return f"{prefix}_{next(_ids)}"


@dataclasses.dataclass
class Node:
    """One IR operator."""

    op: str
    category: str
    inputs: List[str]
    attrs: Dict[str, Any]
    out_kind: str                   # "table" | "matrix" | "scalar"
    id: str = ""
    runtime: str = "native"         # native | external | container (paper §5)

    def __post_init__(self):
        if not self.id:
            self.id = _fresh_id(self.op)

    def copy(self, **overrides) -> "Node":
        data = dict(op=self.op, category=self.category,
                    inputs=list(self.inputs), attrs=dict(self.attrs),
                    out_kind=self.out_kind, id=self.id, runtime=self.runtime)
        data.update(overrides)
        return Node(**data)

    def __repr__(self):
        ins = ",".join(self.inputs)
        return f"{self.id}:{self.op}[{self.category}]({ins})"


class Plan:
    """A DAG of :class:`Node` with a single output node."""

    def __init__(self, nodes: Optional[Dict[str, Node]] = None,
                 output: Optional[str] = None):
        self.nodes: Dict[str, Node] = dict(nodes or {})
        self.output: Optional[str] = output

    # -- construction --------------------------------------------------------
    def add(self, node: Node) -> str:
        if node.id in self.nodes:
            raise ValueError(f"duplicate node id {node.id}")
        self.nodes[node.id] = node
        return node.id

    def emit(self, op: str, category: str, inputs: Sequence[str],
             out_kind: str, runtime: str = "native", **attrs) -> str:
        return self.add(Node(op=op, category=category, inputs=list(inputs),
                             attrs=attrs, out_kind=out_kind, runtime=runtime))

    # -- topology -------------------------------------------------------------
    def topo_order(self) -> List[str]:
        order: List[str] = []
        seen: Set[str] = set()

        def visit(nid: str):
            if nid in seen:
                return
            seen.add(nid)
            for dep in self.nodes[nid].inputs:
                visit(dep)
            order.append(nid)

        if self.output is not None:
            visit(self.output)
        # include orphan roots too (multi-sink plans during rewriting)
        for nid in list(self.nodes):
            visit(nid)
        return order

    def consumers(self, nid: str) -> List[str]:
        return [n.id for n in self.nodes.values() if nid in n.inputs]

    def node(self, nid: str) -> Node:
        return self.nodes[nid]

    # -- rewriting --------------------------------------------------------------
    def replace(self, old_id: str, new_node: Node) -> str:
        """Replace node ``old_id``; consumers are re-pointed to the new id."""
        self.nodes.pop(old_id)
        if new_node.id in self.nodes:
            new_id = new_node.id
        else:
            new_id = self.add(new_node)
        for n in self.nodes.values():
            n.inputs = [new_id if i == old_id else i for i in n.inputs]
        if self.output == old_id:
            self.output = new_id
        return new_id

    def rewire(self, old_id: str, new_id: str) -> None:
        """Point all consumers of ``old_id`` at ``new_id`` (bypass)."""
        for n in self.nodes.values():
            if n.id == new_id:
                continue
            n.inputs = [new_id if i == old_id else i for i in n.inputs]
        if self.output == old_id:
            self.output = new_id

    def prune_dead(self) -> int:
        """Drop nodes unreachable from the output.  Returns count removed."""
        if self.output is None:
            return 0
        live: Set[str] = set()

        def visit(nid: str):
            if nid in live:
                return
            live.add(nid)
            for dep in self.nodes[nid].inputs:
                visit(dep)

        visit(self.output)
        dead = [nid for nid in self.nodes if nid not in live]
        for nid in dead:
            del self.nodes[nid]
        return len(dead)

    def find(self, op: str) -> List[Node]:
        return [n for n in self.topo_ordered_nodes() if n.op == op]

    def topo_ordered_nodes(self) -> List[Node]:
        return [self.nodes[i] for i in self.topo_order()]

    # -- validation / display -----------------------------------------------------
    def validate(self) -> None:
        for n in self.nodes.values():
            for dep in n.inputs:
                if dep not in self.nodes:
                    raise ValueError(f"{n.id} references missing input {dep}")
        if self.output is not None and self.output not in self.nodes:
            raise ValueError(f"output {self.output} missing")
        # acyclicity via topo
        self.topo_order()

    def pretty(self) -> str:
        lines = []
        for nid in self.topo_order():
            n = self.nodes[nid]
            mark = " <- OUTPUT" if nid == self.output else ""
            extra = ""
            if n.op == "filter":
                extra = f" pred={n.attrs['predicate']!r}"
            elif n.op == "scan":
                extra = f" table={n.attrs['table']}"
            elif n.op == "predict_model":
                extra = f" model={n.attrs.get('model_name')}"
            lines.append(
                f"  {n.id:<24} {n.category:<4} {n.op:<16} "
                f"inputs={n.inputs}{extra} rt={n.runtime}{mark}")
        return "\n".join(lines)

    def copy(self) -> "Plan":
        return Plan({k: v.copy() for k, v in self.nodes.items()}, self.output)

    def stats(self) -> Dict[str, int]:
        by_cat: Dict[str, int] = {}
        for n in self.nodes.values():
            by_cat[n.category] = by_cat.get(n.category, 0) + 1
        return by_cat

    def signature(self) -> str:
        return plan_signature(self)


# ---------------------------------------------------------------------------
# Structural canonicalization + plan signature.
#
# Two plans that compute the same thing must hash identically even when their
# auto-generated node ids differ (the global ``_ids`` counter makes ids
# session-dependent) and regardless of attr-dict insertion order.  Node
# identity is therefore *positional*: nodes are numbered by a deterministic
# DFS from the output, attrs are canonicalized recursively (models and
# featurizers by content digest — see ``model_store.content_fingerprint`` —
# so the signature is sensitive to retrained weights but blind to Python
# object identity).  The signature is the cache key half contributed by the
# query; the serving layer combines it with table schemas + ExecutionConfig.
# ---------------------------------------------------------------------------

def canonical_form(plan: Plan) -> Tuple:
    """Canonical structural form of the sub-DAG reachable from the output."""
    from .model_store import _canon_value

    if plan.output is None:
        raise ValueError("cannot canonicalize a plan with no output")
    order = subtree_nodes(plan, plan.output)
    pos = {nid: i for i, nid in enumerate(order)}
    entries = []
    for nid in order:
        n = plan.nodes[nid]
        attrs = tuple(sorted(
            (k, _canon_value(v)) for k, v in n.attrs.items()))
        entries.append((n.op, n.category, n.runtime, n.out_kind,
                        tuple(pos[i] for i in n.inputs), attrs))
    return (tuple(entries), pos[plan.output])


def plan_signature(plan: Plan) -> str:
    """Stable hex signature of a plan's structure + embedded model content.

    Signatures are deliberately **shape-agnostic**: no row count or table
    cardinality enters the hash, only structure, attrs and model content.
    That is what lets the serving layer map one signature onto a small
    family of shape-specialized executables (see :func:`bucketed_signature`)
    instead of recompiling per batch size."""
    return hashlib.sha256(
        repr(canonical_form(plan)).encode("utf-8")).hexdigest()


def bucketed_signature(sig: str, bucket_rows: int) -> str:
    """Identity of a shape-specialized executable: the (shape-agnostic)
    structural signature extended with the padded row bucket it was
    compiled for.  The serving layer keys bucket executables in its cost-aware
    cache under this, so varying batch sizes hit one of O(log max_batch)
    entries rather than forcing a recompile per distinct size."""
    return f"{sig}@rows{int(bucket_rows)}"


def sharded_signature(sig: str, bucket_rows: int,
                      mesh_shape: Tuple[int, ...],
                      side_buckets: Sequence[Tuple[str, int]] = (),
                      exchange: Optional[Tuple[int, int]] = None) -> str:
    """Identity of a partition-parallel executable: the structural
    signature plus the per-device morsel row bucket it was compiled for and
    the mesh shape it is placed across.  Note the structural half is
    already **partition-aware**: a scan's surviving-partition set lives in
    its ``partitions`` attr, which participates in ``canonical_form`` — a
    plan pruned to a different partition set is a different signature, so
    pruned and unpruned executions never share an executable entry.

    ``side_buckets`` extends the identity for partition-wise joins: each
    non-anchor join input is gathered at its own padded row bucket
    (``(table name, bucket rows)`` pairs), and those shapes are part of
    what the executable is specialized for — two placements whose side
    buckets differ must not share an entry.

    ``exchange`` extends the identity for hash-repartition shuffle
    execution: ``(n_buckets, anchor_bucket_rows)`` — the number of hash
    buckets the join key was split into and the padded per-bucket anchor
    row capacity.  An exchanged execution pads both join sides to
    bucket-local capacities that depend on the hash split, not on the
    catalog partition layout, so the same structural plan exchanged at a
    different bucket count (or re-registered with different data skew)
    must map to a distinct executable entry."""
    mesh = "x".join(str(int(d)) for d in mesh_shape)
    sides = "".join(f"@{name}:{int(rows)}"
                    for name, rows in sorted(side_buckets))
    exch = ""
    if exchange is not None:
        n_buckets, anchor_rows = exchange
        exch = f"@exch{int(n_buckets)}:{int(anchor_rows)}"
    return f"{sig}@rows{int(bucket_rows)}@mesh{mesh}{sides}{exch}"


# ---------------------------------------------------------------------------
# Per-subtree signatures (cross-query sub-plan reuse).
#
# The serving layer's result cache needs to recognize that two *different*
# queries share a sub-plan (e.g. the same ``featurize -> predict_model``
# prefix over the same scan).  A node's subtree signature is, by
# construction, exactly ``plan_signature`` of the plan truncated at that
# node, so a sub-plan materialized under one query is addressable from any
# other plan containing a structurally identical subtree.  The expensive
# attr canonicalization (model weights etc.) is memoized per object in
# ``model_store._CANON_MEMO``, so the whole-plan sweep stays cheap.
# ---------------------------------------------------------------------------

def subtree_signatures(plan: Plan) -> Dict[str, str]:
    """Signature of the sub-DAG rooted at every node reachable from the
    output.  ``subtree_signatures(p)[p.output] == plan_signature(p)``.

    O(n) truncated-plan hashes, i.e. O(n^2) node visits — fine at current
    plan sizes (tens of nodes; model attrs, the expensive part, are
    memoized in ``model_store._CANON_MEMO``).  If plans grow to hundreds of
    nodes, switch to a bottom-up Merkle construction (child signatures
    hashed into the parent) — that changes signature *values*, which is
    safe for caches (pure identity) but must land in one PR with this
    truncation equivalence redefined accordingly."""
    if plan.output is None:
        raise ValueError("cannot sign a plan with no output")
    return {nid: plan_signature(Plan(plan.nodes, output=nid))
            for nid in subtree_nodes(plan, plan.output)}


def subtree_nodes(plan: Plan, root: str) -> List[str]:
    """Node ids reachable from ``root`` (the sub-plan it denotes), in a
    deterministic DFS post-order."""
    order: List[str] = []
    seen: Set[str] = set()

    def visit(nid: str):
        if nid in seen:
            return
        seen.add(nid)
        for dep in plan.nodes[nid].inputs:
            visit(dep)
        order.append(nid)

    visit(root)
    return order


# Ops whose output is a pure function of their inputs + attrs.  ``udf`` is
# excluded: an opaque host callable may consult state the content
# fingerprint cannot see (RNG, files, wall clock), so UDF subtrees are never
# merged across invocations nor result-cached.
_NONDETERMINISTIC_OPS = frozenset({"udf"})


def is_deterministic_subtree(plan: Plan, root: str) -> bool:
    """True iff every op under ``root`` is deterministic and side-effect
    free — the precondition for merging duplicate subtrees within a plan
    (subplan_dedup) and for materializing a subtree's result across queries
    (the serving layer's result cache)."""
    return all(plan.nodes[nid].op not in _NONDETERMINISTIC_OPS
               for nid in subtree_nodes(plan, root))


def plan_params(plan: Plan, nids: Optional[Sequence[str]] = None
                ) -> FrozenSet[str]:
    """Names of unbound :class:`~repro_torch.relational.expr.Param` placeholders
    appearing in the expressions of ``plan`` (or just the nodes in
    ``nids``).  A parameterized plan canonicalizes by parameter *name*, so
    one signature serves every literal binding — but its subtrees are not
    result-cacheable (the cache key would not see the values) and its
    execution needs a ``__params__`` binding; both call sites gate on this
    helper."""
    from ..relational.expr import Expr, expr_params
    names: Set[str] = set()
    for nid in (nids if nids is not None else plan.nodes):
        for v in plan.nodes[nid].attrs.values():
            if isinstance(v, Expr):
                names |= expr_params(v)
    return frozenset(names)
