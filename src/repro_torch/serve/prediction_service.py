"""Prediction-query serving layer: compile-once / serve-many (paper §5).

The paper's biggest native-integration wins come from batch inference with
model + inference-session caching inside the engine (up to 5.5x).  This
module generalizes that idea from cached ONNX sessions to *whole optimized
query plans* and their *materialized sub-results*.  Three cache tiers, each
feeding the next:

1. **executable cache** — ``(plan signature, scanned-table schemas,
   ExecutionConfig)`` -> optimized plan + its codegen closure, with the
   model constants already on the catalog's device.  Structural
   canonicalization in ``core.ir`` makes the key independent of node-id
   counters and attr ordering; model references hash by content digest
   (``model_store.content_fingerprint``), so re-registering a retrained
   model misses while a byte-identical re-registration hits.
2. **materialized result cache** — cross-query sub-plan reuse.  Each
   compiled plan designates its most expensive *cacheable* subtree (see
   below); executing the plan also returns that subtree's value (a
   ``capture`` output of the closure — the first query pays nothing
   beyond keeping one extra tensor), which is stored under the subtree's
   structural signature (``ir.subtree_signatures``) + the versions of the
   catalog tables it read.  When a *different* query later compiles and
   one of its subtrees carries a cached signature, the service
   **splices**: the subtree is replaced by a ``materialized`` leaf and only
   the residual plan executes — the shared ``featurize -> predict_model``
   prefix is never recomputed.  If the cached value was evicted meanwhile,
   the subtree plan kept alongside the residual re-materializes it on
   demand.  A query that compiled *before* its subtree was cached upgrades
   on a later warm hit: when a different query has since materialized the
   subtree (result entries carry a producer tag), the entry recompiles to
   its residual once and splices from then on — the producer itself stays
   fused, preserving the zero-compile warm-repeat guarantee.
3. **cost-aware eviction + invalidation** — both caches share the
   :class:`~repro_torch.serve.cache.CostAwareCache` policy: victim = lowest
   ``observed cost x hit count`` under slot and bytes budgets (bytes
   measured from cached tensor sizes: device memory on the card).  A
   ``ModelStore`` invalidation hook fires on ``register_model`` /
   ``register_table`` and evicts exactly the entries whose plans reference
   the re-registered name — content digests already make stale entries
   unreachable, the hook frees their budget.

**When is result splicing legal?**  Only for subtrees that are (a)
deterministic and side-effect free (every op pure; UDFs excluded — an
opaque host callable may consult hidden state), (b) reading only
*registered catalog tables*, never caller-supplied request tables (the
cache key pins each table's registration version), and (c) bit-exact:
the cached value is the output of the same closure the uncached plan
would run, so splicing can never change results — only skip recomputing
them.

Execution is eager: a plan's closure launches its device work on the
tables' device (the card for ``ModelStore()``), and every served result
is synchronized before its ticket resolves, so compile, execution and
queue latencies — and the costs eviction ranks by — measure the work and
not its enqueue.  ``jit=True`` keeps the executable tier's trace
accounting: each executable counts one ``jit_traces`` per distinct input
signature (table capacities, column dtypes and trailing shapes, bound
parameter names), what a tracing compiler would specialize on.

Execution tiers below the caches:

- **morsel (chunked) execution** — large scans split into fixed-size row
  chunks with a tail-padding path (pad rows carry ``valid=False``), so a
  plan sees exactly one chunk shape regardless of table size.  Only
  row-local single-scan plans chunk.  Under ``ExecutionConfig(
  sharded=True)`` the partition-parallel tier additionally covers plans
  the ``distributed_plan`` rule rewrote — partition-wise joins over
  co-partitioned tables, hash-exchanged joins and two-phase (partial +
  combine) aggregations — see ``_execute_distributed``; everything else
  falls back to whole-table execution.
- **micro-batch admission** — concurrent requests sharing a plan signature
  coalesce: row-local plans stack their input tables into one padded batch
  execution and split the results; requests over identical catalog tables
  share a single execution.  Coalescing happens at explicit ``flush()``
  boundaries, or continuously when an admission loop is configured (below).

**Continuous batching** (``admission=AdmissionConfig(...)``): a background
admission thread coalesces in-flight same-signature requests inside a
latency budget instead of waiting for an explicit ``flush()``.  Both the
explicit-flush path and the loop drain the same
:class:`~repro_torch.serve.admission.Batcher`.  The knobs (see
:class:`~repro_torch.serve.admission.AdmissionConfig`):

- ``latency_budget_s`` — how long an admitted request may wait for
  batch-mates; the loop flushes a group early when its *oldest* request's
  deadline is about to expire, so p95 queue latency stays bounded by
  roughly budget + one batch execution.
- ``max_queue`` — backpressure: ``submit()`` blocks while this many
  requests are pending (or raises ``AdmissionQueueFull`` with
  ``block_on_full=False`` / on ``offer_timeout_s`` expiry), so producers
  degrade to the service's drain rate instead of queueing unboundedly.
- ``max_batch_requests`` — a group this large flushes immediately.
- ``min_bucket_rows`` / ``max_bucket_rows`` — **shape-bucket policy**:
  stacked batches pad to the next power-of-two row bucket, and the bucket
  is part of the executable-cache key (``ir.bucketed_signature``), so any
  batch size hits one of O(log max_batch) executables — bit-exact after
  unpadding, with compile counts independent of arrival patterns.
- ``background`` — start the loop thread (it launches its batches on the
  current CUDA stream, one batch at a time under ``_flush_lock``);
  ``False`` plus an injected
  :class:`~repro_torch.serve.admission.ManualClock` gives a deterministic
  harness (tests drive ``admission_tick()`` with a fake clock, no sleeps).

``close()`` stops the loop, drains every in-flight request (no ticket is
lost), and detaches the catalog invalidation hook.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import weakref
from typing import (Any, Dict, List, Mapping, Optional, Set, Tuple, Union)

import torch

from ..core.codegen import (ExecutionConfig, _sync, add_compile_listener,
                            add_trace_listener, bind_structural_params,
                            compile_plan, count_jit_trace, pow2_bucket,
                            resolve_params)
from ..core.ir import (Node, Plan, ROW_LOCAL_OPS, bucketed_signature,
                       is_deterministic_subtree, plan_params, plan_signature,
                       sharded_signature, subtree_nodes, subtree_signatures)
from ..core.optimizer import (CrossOptimizer, OptimizationReport,
                              OptimizerConfig, referenced_models)
from ..core.sql_frontend import parse_query
from ..relational.ops import combine_partials, merge_partial_states
from ..relational.table import Schema, Table, to_numpy
from .admission import (AdmissionConfig, AdmissionLoop, AdmissionQueueFull,
                        Batcher, Clock, DeadlineUnmeetable, ReadyGroup,
                        SystemClock)
from .cache import CostAwareCache
from .context import RequestContext, Session, TenantPolicy
from .sharded import ShardedExecutor, _concat_outputs, side_bucket_rows
from .telemetry import (MetricsRegistry, NULL_TRACE, Trace, chrome_trace,
                        next_trace_id)

__all__ = ["PredictionService", "ServiceStats", "PredictionTicket",
           "CompiledPrediction", "DistributedSpec", "AggStage",
           "ExchangeSpec", "SubplanRef", "RequestContext", "Session",
           "TenantPolicy", "TenantStats", "ExplainResult"]


# Ops whose output rows correspond 1:1 (positionally) to their input rows —
# the precondition for both chunked execution and request stacking.  Joins,
# aggregation, ordering, limits and unions break the correspondence; UDFs
# are excluded conservatively (a host callback may inspect the whole batch).
# Shared with the distributed_plan rule via core/ir.py so the serving
# layer's and the optimizer's notions of "row-local" cannot drift.
_ROW_LOCAL_OPS = ROW_LOCAL_OPS

# Subtrees worth materializing across queries: anything doing model
# inference or feature construction, plus anything that leaves the process
# (external/container runtimes pay a per-execution hop).
_EXPENSIVE_OPS = frozenset({
    "featurize", "predict_model", "tree_gemm", "matmul_bias",
    "gather_features",
})


@dataclasses.dataclass
class ServiceStats:
    # ``cache_hits``/``cache_misses`` count *signature* lookups only: a
    # miss here means a query structure the service had not compiled.
    # Shape-driven executable builds (a known signature re-wrapped for a
    # new row bucket) count under ``bucket_compiles`` instead — folding
    # them into ``cache_misses`` would hide unbounded shape recompilation
    # behind a healthy-looking signature hit rate (and vice versa).
    cache_hits: int = 0
    cache_misses: int = 0
    evictions: int = 0              # executable-cache budget evictions
    batch_executions: int = 0       # actual executions issued to the engine
    coalesced_requests: int = 0     # requests served without their own execution
    chunks_executed: int = 0
    # result-cache tier
    result_hits: int = 0            # spliced executions served from cache
    result_misses: int = 0          # spliced executions that re-materialized
    result_puts: int = 0
    result_evictions: int = 0       # result-cache budget evictions
    spliced_executions: int = 0
    splice_upgrades: int = 0        # capture-compiled entries re-wired to
                                    # splice when another query materialized
                                    # their subtree after they compiled
    rematerializations: int = 0
    invalidation_evictions: int = 0  # entries freed by register_* hooks
    # continuous-batching tier
    submitted: int = 0              # tickets admitted to the batcher
    bucket_compiles: int = 0        # shape-bucket executables built (re-
                                    # wraps of a cached signature for a new
                                    # bucket)
    bucket_hits: int = 0            # stacked executions reusing a bucket
    jit_traces: int = 0             # distinct input signatures an
                                    # executable saw (see ``_jit``)
    deadline_flushes: int = 0       # groups released by the latency budget
    size_flushes: int = 0           # groups released by max_batch_requests
    drain_flushes: int = 0          # groups released by flush()/close()
    queue_rejections: int = 0       # submits refused by backpressure
    # partition-parallel (sharded) tier
    sharded_executions: int = 0     # logical executions routed to devices
    shard_compiles: int = 0         # sharded twin executables built
    shard_hits: int = 0             # sharded executions reusing a twin
    shard_waves: int = 0            # morsel waves dispatched
    partitions_scanned: int = 0     # partitions actually placed on devices
    partitions_pruned: int = 0      # partitions skipped via zone maps
    # distributed plans (partition-wise joins / two-phase aggregation)
    shard_join_executions: int = 0  # sharded serves containing a
                                    # partition-wise or exchange join
    shard_agg_combines: int = 0     # two-phase combine stages run
    shard_partial_aggs: int = 0     # per-morsel partial aggregates computed
    # hash-repartition exchange (serve/exchange.py)
    exchange_executions: int = 0    # shuffle-exchange stages run
    exchange_fallbacks: int = 0     # exchanges the cost gate sent whole-table
    exchange_bytes_moved: int = 0   # actual shuffle payload (pre-padding)
    # deadline-based shedding (admission front door)
    deadline_rejections: int = 0    # submits shed as DeadlineUnmeetable
    # SQL front door
    sql_parses: int = 0             # SQL texts parsed (parse-cache misses)
    sql_parse_hits: int = 0         # SQL texts served from the parse cache
    # streaming ingest (ModelStore.append_rows front door)
    appends_observed: int = 0       # stats-stable append events seen
    delta_serves: int = 0           # serves that executed only appended rows
    delta_rows_scanned: int = 0     # appended rows touched by delta serves
    delta_fallbacks: int = 0        # post-append serves sent whole-table
    stale_serves: int = 0           # pre-append snapshots served within SLA
    prefix_supersedes: int = 0      # prefix entries retired by delta results
    append_upgrades: int = 0        # capture entries re-wired to splice when
                                    # their table grew under them


@dataclasses.dataclass
class TenantStats:
    """Per-tenant serving ledger (``tenant_info()``).  Latencies record
    seconds each of the tenant's requests waited in admission, measured on
    the injected clock — the p50/p95 the saturation benchmark bounds."""

    submitted: int = 0
    served: int = 0
    coalesced: int = 0
    deadline_rejections: int = 0     # submits shed as DeadlineUnmeetable
    latencies: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=2048))
    # Per-tenant admission queue-wait EWMA (injected-clock seconds): the
    # deadline shedder prefers this over the global EWMA so one flooded
    # tenant's backlog never inflates a compliant tenant's estimate (and
    # vice versa — the flooded tenant sheds on *its own* numbers).
    queue_wait_ewma: Optional[float] = None


@dataclasses.dataclass
class SubplanRef:
    """Identity of a materializable sub-plan inside a compiled query."""

    sig: str                         # structural signature of the subtree
    slot: str                        # tables-dict key the value is injected as
    subtree_plan: Plan               # standalone copy (re-materialization)
    scan_tables: Tuple[str, ...]     # catalog tables the subtree reads
    tags: Tuple[Any, ...]            # ("model", name) / ("table", name)
    n_nodes: int
    _fn: Any = None                  # lazily compiled subtree executable
    _raw_fn: Any = None              # unwrapped subtree closure; the
                                     # delta tier wraps it per append bucket

    def describe(self) -> str:
        root = self.subtree_plan.nodes[self.subtree_plan.output]
        return f"{root.op}[{self.n_nodes} nodes] over {self.scan_tables}"

@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """One hash-repartition shuffle inside a local plan: the equi-join's
    key column (intact at both scans, so the same name addresses it on
    both sides) and the two partitioned tables to bucket.  ``left`` is
    the anchor — output rows follow its rows through the scatter-back."""

    on: str                           # join key column name
    left: str                         # anchor-side partitioned table
    right: str                        # other side's partitioned table
    join_id: str = ""                 # plan node carrying the mark


@dataclasses.dataclass
class AggStage:
    """One two-phase aggregation's local half: the sub-plan below the
    ``group_agg`` capped with a ``partial_agg`` head, plus everything the
    executor needs to run it partition-wise (or via an exchange) and fold
    the per-morsel partials into the residual's ``slot``."""

    key: Optional[str]                # group-by column (None = scalar aggs)
    aggs: Dict[str, Tuple]            # out name -> (fn, col)
    slot: str                         # materialized-slot the residual reads
    anchor: str                       # partitioned table driving placement
    part_tables: Tuple[str, ...]      # partitioned scans, anchor first
    local_plan: Plan
    local_raw_fn: Any
    local_sig: str
    n_joins: int = 0                  # partition-wise joins in local_plan
    exchange: Optional[ExchangeSpec] = None


@dataclasses.dataclass
class DistributedSpec:
    """Local/global split of a distributed-rewritten plan
    (``core/rules/distributed_plan.py``), derived once at compile time.

    Join-only plans use the top-level fields: the *local* plan is the
    whole plan, run per morsel (co-partitioned) or per hash bucket
    (``exchange``).  Two-phase aggregation plans carry one
    :class:`AggStage` per eligible ``group_agg`` in ``stages`` — each
    stage's partials fold independently into its slot, and ``global_fn``
    (the residual above the aggregations, reading every slot through
    ``materialized`` leaves) runs over the tiny combined
    tables."""

    anchor: str                       # partitioned table driving placement
    part_tables: Tuple[str, ...]      # union of partitioned scans across
                                      # stages (version-check set)
    local_plan: Plan                  # per-morsel program (join-only mode)
    local_raw_fn: Any                 # unwrapped closure for local_plan
    local_sig: str                    # plan_signature(local_plan): the
                                      # sharded-twin identity half
    n_joins: int = 0                  # partition-wise joins in local_plan
    exchange: Optional[ExchangeSpec] = None   # join-only shuffle, if any
    # two-phase aggregation stages (empty for join-only plans):
    stages: Tuple[AggStage, ...] = ()
    global_fn: Any = None             # residual above the aggs; reads slots


@dataclasses.dataclass
class CompiledPrediction:
    """A cached, ready-to-serve query: optimized plan + its executable."""

    key: Tuple
    signature: str
    plan: Plan                       # executed plan (residual when spliced)
    report: OptimizationReport
    fn: Any                          # (tables dict) -> Table | array
    scan_tables: Tuple[str, ...]
    chunk_table: Optional[str]       # set iff the plan is row-local/chunkable
    compile_time_s: float = 0.0
    serves: int = 0
    model_names: Tuple[str, ...] = ()
    capture: Optional[SubplanRef] = None   # fn returns (out, captured value)
    splice: Optional[SubplanRef] = None    # fn reads capture via slot input
    raw_fn: Any = None               # unwrapped closure; shape-bucket
                                     # entries re-wrap it rather than
                                     # re-running optimize + codegen
    bucket_rows: Optional[int] = None      # set on shape-bucket entries
    # Catalog table versions at compile time.  The sharded path compares
    # them before trusting the plan's pruned-partition set: a table
    # re-registered mid-flight (invalidation hooks evict this entry, but
    # an execution already holding it races that) may keep its partition
    # *count* while its data — and therefore its zone maps — changed.
    catalog_versions: Tuple[Tuple[str, int], ...] = ()
    # Local/global split for plans the distributed_plan rule rewrote
    # (partition-wise joins / two-phase aggregation); None for row-local
    # and whole-table plans.
    dist: Optional[DistributedSpec] = None


class PredictionTicket:
    """Handle for a submitted request; resolved at the next ``flush()``.

    ``result(timeout=...)`` raises :class:`TimeoutError` on expiry — it
    never returns ``None`` for an unserved request (a silent ``None`` is
    indistinguishable from a legitimate null result downstream).
    """

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._trace: Any = None

    def trace(self):
        """The request's span tree (:class:`~repro.serve.telemetry.Trace`),
        or ``None`` when the service runs ``telemetry=False``.  Spans keep
        accumulating until the request is served — read after ``result()``
        for the complete tree."""
        return self._trace

    def _resolve(self, value: Any):
        # a double resolution would mean two executions raced for one
        # request — surface it instead of silently overwriting
        if self._event.is_set():
            raise RuntimeError("ticket resolved twice")
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException):
        if self._event.is_set():
            raise RuntimeError("ticket resolved twice")
        self._error = err
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("prediction not yet served; call flush()")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class _Pending:
    plan: Plan
    tables: Optional[Dict[str, Table]]
    ticket: PredictionTicket
    # Resolved parameter bindings (name -> device scalar) for parameterized
    # queries; None on the unparameterized path.  Requests only group when
    # their bindings are bit-identical (the fingerprint is part of the
    # batch key), so one group always shares one binding.
    params: Optional[Dict[str, Any]] = None
    ctx: Optional[RequestContext] = None
    # The request's Trace (NULL_TRACE when telemetry is off).  Carried here
    # rather than only on ctx because the single-tenant path runs ctx=None.
    trace: Any = NULL_TRACE
    # ``threading.get_ident()`` of the submitting thread: the ``lane_wait``
    # span tells whether the thread that served the group was its own.
    thread: int = 0


# ---------------------------------------------------------------------------
# Row plumbing: slicing, padding, stacking, splitting — all on the tables'
# device.  Eager execution specializes nothing on shapes, so there is no
# reason to route rows through the host (a host round trip of a 1M-row
# column costs more than the query on the card).  Pure data movement:
# bit-exact by construction; pad rows carry ``valid=False``.
# ---------------------------------------------------------------------------

def _schema_sig(schema: Schema) -> Tuple:
    """Order-insensitive schema identity (column order never changes what a
    plan computes — columns are addressed by name)."""
    return tuple(sorted((c.name, str(c.dtype), c.dictionary)
                        for c in schema.columns))


def _pad_rows(v: torch.Tensor, pad: int) -> torch.Tensor:
    """``v`` followed by ``pad`` zero rows (False for a bool mask)."""
    return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])


def _pad_table(table: Table, target: int) -> Table:
    n = table.capacity
    if n == target:
        return table
    pad = target - n
    cols = {k: _pad_rows(v, pad) for k, v in table.columns.items()}
    return Table(cols, _pad_rows(table.valid, pad), table.schema)


def _slice_table(table: Table, start: int, size: int) -> Table:
    """Row range ``[start, start + size)``, False-padded to exactly
    ``size`` rows past the table's end."""
    end = min(start + size, table.capacity)
    cols = {k: v[start:end] for k, v in table.columns.items()}
    part = Table(cols, table.valid[start:end], table.schema)
    return _pad_table(part, size)


def _stack_pad(tables: List[Table], target: int) -> Table:
    """Stack request tables and pad to ``target`` rows."""
    base = tables[0]
    n = sum(t.capacity for t in tables)
    pad = max(0, target - n)
    if len(tables) == 1 and pad == 0:
        return base                    # already bucket-shaped: zero copies
    cols = {}
    for k in base.columns:
        parts = [t.columns[k] for t in tables]
        col = parts[0] if len(parts) == 1 else torch.cat(parts)
        cols[k] = _pad_rows(col, pad) if pad else col
    valid = torch.cat([t.valid for t in tables])
    if pad:
        valid = _pad_rows(valid, pad)
    return Table(cols, valid, base.schema)


def _rows_of(out: Any) -> int:
    if isinstance(out, Table):
        return out.capacity
    return out.shape[0]


def _split_output(out: Any, sizes: List[int]) -> List[Any]:
    """Split a stacked output back into per-request results.  Each piece
    is a copy, so a caller keeping one small result alive never pins the
    whole padded batch's memory."""
    if len(sizes) == 1 and _rows_of(out) == sizes[0]:
        return [out]                   # unpadded single request: as-is
    bounds = [0]
    for s in sizes:
        bounds.append(bounds[-1] + s)
    if isinstance(out, Table):
        return [Table({k: v[bounds[i]:bounds[i + 1]].clone()
                       for k, v in out.columns.items()},
                      out.valid[bounds[i]:bounds[i + 1]].clone(),
                      out.schema)
                for i in range(len(sizes))]
    return [out[bounds[i]:bounds[i + 1]].clone() for i in range(len(sizes))]


def _trim_rows(out: Any, n: int) -> Any:
    if isinstance(out, Table):
        return Table({k: v[:n] for k, v in out.columns.items()},
                     out.valid[:n], out.schema)
    return out[:n]


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _ready(value: Any) -> Any:
    """Synchronize the device a served value lives on, then return it.
    Launches are asynchronous on the card: every latency and cost this
    module measures, and every ticket it resolves, waits here first."""
    devices = set()

    def walk(v: Any) -> None:
        if isinstance(v, torch.Tensor):
            devices.add(v.device)
        elif isinstance(v, Table):
            walk(v.valid)
            for c in v.columns.values():
                walk(c)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    walk(value)
    for d in devices:
        _sync(d)
    return value


def _input_signature(tables: Dict[str, Any]) -> Tuple:
    """What a tracing compiler specializes an executable on: each table's
    capacity and its columns' dtypes and trailing shapes, each bare
    tensor's dtype and shape, and the bound parameters' names (with their
    dtype kind and shape).  Values never enter it."""

    def sig(v: Any) -> Any:
        if isinstance(v, Table):
            return ("table", v.capacity, tuple(sorted(
                (k, str(c.dtype), tuple(c.shape[1:]))
                for k, c in v.columns.items())))
        if isinstance(v, torch.Tensor):
            return ("tensor", str(v.dtype), tuple(v.shape))
        if isinstance(v, dict):
            return ("params", tuple(sorted(
                (k, to_numpy(x).dtype.kind, tuple(to_numpy(x).shape))
                for k, x in v.items())))
        return (type(v).__name__,)

    return tuple(sorted((k, sig(v)) for k, v in tables.items()))


# ---------------------------------------------------------------------------
# Plan introspection for the result-cache tier.
# ---------------------------------------------------------------------------

def _scan_names(plan: Plan, nids=None) -> Tuple[str, ...]:
    nodes = [plan.nodes[i] for i in nids] if nids is not None \
        else list(plan.nodes.values())
    return tuple(sorted({n.attrs["table"] for n in nodes if n.op == "scan"}))


def _artifact_nbytes(plan: Plan) -> int:
    """Bytes of array constants baked into a plan (model weights, folded
    literals) — the dominant, measurable share of a cached executable's
    footprint."""
    seen: Set[int] = set()

    def walk(v: Any, depth: int = 0) -> int:
        if v is None or depth > 4 or id(v) in seen:
            return 0
        if hasattr(v, "nbytes"):
            seen.add(id(v))
            return int(v.nbytes)
        if isinstance(v, dict):
            return sum(walk(x, depth + 1) for x in v.values())
        if isinstance(v, (list, tuple)):
            return sum(walk(x, depth + 1) for x in v)
        if hasattr(v, "__dict__"):
            seen.add(id(v))
            return sum(walk(x, depth + 1) for x in vars(v).values())
        return 0

    return sum(walk(n.attrs) for n in plan.nodes.values())


@dataclasses.dataclass
class ExplainResult:
    """Rendered optimized plan, optionally annotated with measured
    per-operator wall time and row counts (``service.explain(...,
    analyze=True)``).

    ``samples`` maps node id -> ``(wall seconds, output rows)`` from an
    instrumented (per-op-synchronized) run of the exact compiled
    plan; ``total_s`` is that run's end-to-end wall time, so
    ``measured_s`` — the per-operator sum — accounts for all but the
    interpreter's dispatch overhead."""

    plan: Plan
    report: OptimizationReport
    compiled: CompiledPrediction
    analyze: bool = False
    samples: Dict[str, Tuple[float, int]] = dataclasses.field(
        default_factory=dict)
    total_s: float = 0.0

    @property
    def measured_s(self) -> float:
        """Sum of per-operator wall times (analyze runs only)."""
        return sum(dt for dt, _ in self.samples.values())

    def operators(self) -> List[Tuple[str, Node]]:
        """(nid, node) pairs in execution (topological) order."""
        return [(nid, self.plan.nodes[nid])
                for nid in self.plan.topo_order()]

    def _detail(self, n: Node) -> str:
        a = n.attrs
        bits: List[str] = []
        if n.op == "scan":
            bits.append(str(a.get("table")))
            pr = self.report.partitions.get(a.get("table"))
            if pr is not None:
                bits.append(f"partitions={pr[0]}/{pr[1]}")
            elif a.get("partitions") is not None:
                bits.append(f"partitions={len(a['partitions'])}")
        elif n.op == "join":
            bits.append(f"on={a.get('on')}")
            if a.get("partition_wise"):
                bits.append("partition_wise")
            if a.get("exchange"):
                bits.append("exchange")
        elif n.op == "predict_model":
            bits.append(str(a.get("model_name") or a.get("pipeline_name")))
            if a.get("flavor"):
                bits.append(str(a["flavor"]))
            if n.runtime != "native":
                bits.append(f"runtime={n.runtime}")
        elif n.op == "tree_gemm":
            if a.get("strategy"):
                bits.append(f"strategy={a['strategy']}")
        elif n.op in ("group_agg", "partial_agg"):
            if a.get("key"):
                bits.append(f"key={a['key']}")
            if a.get("two_phase"):
                bits.append("two_phase")
        elif n.op == "materialized":
            bits.append(f"spliced sig={str(a.get('sig'))[:12]}")
        elif n.op == "attach_column":
            bits.append(str(a.get("name")))
        return f" [{', '.join(bits)}]" if bits else ""

    def pretty(self) -> str:
        lines: List[str] = []
        plan = self.plan

        def render(nid: str, prefix: str, is_last: bool, is_root: bool):
            n = plan.nodes[nid]
            label = f"{n.op}{self._detail(n)}"
            if nid in self.samples:
                dt, rows = self.samples[nid]
                label += f"  (actual time={dt * 1e3:.3f}ms rows={rows})"
            if is_root:
                lines.append(label)
                child_prefix = ""
            else:
                lines.append(f"{prefix}{'└─ ' if is_last else '├─ '}{label}")
                child_prefix = prefix + ("   " if is_last else "│  ")
            for i, inp in enumerate(n.inputs):
                render(inp, child_prefix, i == len(n.inputs) - 1, False)

        if plan.output is not None:
            render(plan.output, "", True, True)
        if self.analyze:
            lines.append(f"-- operators: {self.measured_s * 1e3:.3f}ms of "
                         f"{self.total_s * 1e3:.3f}ms end-to-end")
        if self.compiled.splice is not None:
            lines.append("-- splice: reading cached "
                         f"{self.compiled.splice.describe()}")
        elif self.compiled.capture is not None:
            lines.append("-- capture: materializing "
                         f"{self.compiled.capture.describe()}")
        if self.compiled.dist is not None:
            d = self.compiled.dist
            mode = "exchange" if d.exchange is not None else (
                "two_phase" if d.stages else "partition_wise")
            lines.append(f"-- distributed: {mode} anchor={d.anchor}")
        if self.report.entries:
            lines.append("-- optimizer rules:")
            for rule, det in self.report.entries:
                t = self.report.rule_times.get(rule)
                stamp = f" ({t * 1e3:.2f}ms)" if t else ""
                lines.append(f"   [{rule}]{stamp} {det}")
        return "\n".join(lines)


class PredictionService:
    """Serves optimized prediction queries under repeated/concurrent load."""

    def __init__(self, catalog,
                 optimizer_config: Optional[OptimizerConfig] = None,
                 execution_config: Optional[ExecutionConfig] = None,
                 jit: bool = True,
                 chunk_rows: int = 0,
                 max_cache_entries: int = 64,
                 exec_cache_bytes: int = 0,
                 result_cache_entries: int = 128,
                 result_cache_bytes: int = 256 << 20,
                 enable_result_cache: bool = True,
                 admission: Optional[AdmissionConfig] = None,
                 clock: Optional[Clock] = None,
                 tenants: Optional[Mapping[str, TenantPolicy]] = None,
                 telemetry: bool = True,
                 trace_capacity: int = 64):
        self.catalog = catalog
        self.optimizer_config = optimizer_config or OptimizerConfig()
        self.execution_config = execution_config or ExecutionConfig()
        self.jit = jit
        self.chunk_rows = int(chunk_rows)
        self.max_cache_entries = int(max_cache_entries)
        self.stats = ServiceStats()
        # Multi-tenant front door: policies are held by reference (the
        # Batcher reads the same dict), so register_tenant() takes effect
        # on the next offer without rebuilding anything.
        self.tenants: Dict[str, TenantPolicy] = dict(tenants or {})
        self._tenant_stats: Dict[str, TenantStats] = {}
        # SQL text -> parsed Plan.  Parsing is pure given the catalog
        # (invalidation hooks clear it), and the optimizer copies its input
        # plan, so a cached parse is never mutated by compilation.
        self._parse_cache: Dict[str, Plan] = {}
        # Streaming ingest: table -> injected-clock time of its most recent
        # stats-stable append (the 'append' invalidation kind).  The
        # freshness-SLA tier compares a request's max_staleness_s budget
        # against this age; a full re-registration clears the entry.
        self._append_times: Dict[str, float] = {}
        self._exec_cache = CostAwareCache(max_entries=max_cache_entries,
                                          max_bytes=exec_cache_bytes)
        self._result_cache: Optional[CostAwareCache] = (
            CostAwareCache(max_entries=result_cache_entries,
                           max_bytes=result_cache_bytes)
            if enable_result_cache else None)
        for name, policy in self.tenants.items():
            self._apply_tenant_quota(name, policy)
        self._lock = threading.Lock()          # stats
        self._flush_lock = threading.Lock()    # serializes batch execution
        # Partition-parallel executor (ExecutionConfig.sharded): built on
        # first sharded execution so unsharded services never enumerate
        # devices.
        self._shard_exec: Optional[ShardedExecutor] = None
        # Admission: explicit-flush mode and the background loop share one
        # Batcher — ``admission=None`` keeps the explicit-flush contract (requests
        # wait for flush(), queue effectively unbounded since only the
        # submitter's own flush can drain it), a config turns on
        # continuous batching with a real bound.
        self.clock = clock or SystemClock()
        self.admission_config = admission
        self.batcher = Batcher(
            admission or AdmissionConfig(background=False,
                                         max_queue=1 << 62),
            clock=self.clock,
            tenant_policies=self.tenants)
        # Per-tenant compile concurrency cap (AdmissionConfig.
        # max_tenant_compiles): the batcher asks *us* whether a batch key
        # is cold — a signature is cold until its executable-cache entry
        # exists, i.e. until its first group compiled.  Weak trampoline:
        # the batcher outlives us on the loop thread, and a bound method
        # here would pin the service against GC.
        wcold = weakref.ref(self)

        def _is_cold(batch_key, _w=wcold):
            svc = _w()
            return False if svc is None else svc._is_cold_key(batch_key)

        self.batcher.is_cold = _is_cold
        self._queue_latencies: collections.deque = collections.deque(
            maxlen=4096)               # seconds waited in admission, per req
        # Deadline-based shedding calibration, both on the injected clock:
        # EWMA of admission queue wait (all requests) and per-cache-key
        # EWMA of group execution time.  A submit whose ctx.deadline_s is
        # below their sum is doomed — reject it at admission instead of
        # letting it occupy queue and batch space only to miss anyway.
        # Both must be warm before anything sheds (a cold signature has no
        # execution estimate, and shedding on no evidence would reject
        # the very request that would calibrate it).
        self._queue_wait_ewma: Optional[float] = None
        self._exec_ewma: Dict[Any, float] = {}
        # -- telemetry: request tracing + unified metrics registry --------
        # ``telemetry=False`` is the pinned-overhead mode: submits carry the
        # shared NULL_TRACE (no span objects, no clock reads) and the hot
        # path never writes the registry (the off-mode test asserts
        # ``metrics.writes == 0``).  The registry itself always exists so
        # ``metrics_text()`` keeps working — pull-time collectors read the
        # stats ledger without hot-path writes.
        self.telemetry = bool(telemetry)
        self.metrics = MetricsRegistry()
        self._traces: collections.deque = collections.deque(
            maxlen=max(1, int(trace_capacity)))
        self._register_collectors()
        self._unsub_codegen: List[Any] = []
        if self.telemetry:
            # Weak trampolines (same GC rationale as the loop callbacks):
            # module-level codegen listeners must not pin the service.
            wreg = weakref.ref(self.metrics)

            def _on_compile(_plan, _w=wreg):
                reg = _w()
                if reg is not None:
                    reg.inc("repro_plans_compiled_total")

            def _on_trace(_w=wreg):
                reg = _w()
                if reg is not None:
                    reg.inc("repro_xla_traces_total")

            self._unsub_codegen = [add_compile_listener(_on_compile),
                                   add_trace_listener(_on_trace)]
        self._loop: Optional[AdmissionLoop] = None
        self._loop_finalizer = None
        if admission is not None and admission.background:
            # Weak trampolines: the loop thread must not pin the service
            # against GC (bound methods would), and a finalizer stops the
            # thread when the last external reference drops — close() is
            # still the orderly path (it drains), but a forgotten service
            # leaks neither its caches nor a daemon thread.
            wsvc = weakref.ref(self)

            def _serve_cb(group, _w=wsvc):
                svc = _w()
                if svc is not None:
                    svc._serve_ready(group)

            def _fail_cb(group, err, _w=wsvc):
                svc = _w()
                if svc is not None:
                    svc._fail_group(group, err)

            self._loop = AdmissionLoop(self.batcher, _serve_cb,
                                       on_error=_fail_cb).start()
            self._loop_finalizer = weakref.finalize(self, self._loop.stop)
        self._unsubscribe_invalidation = None
        if hasattr(catalog, "add_invalidation_listener"):
            # weakref so a long-lived ModelStore does not pin every service
            # ever constructed against it; the GC finalizer (or close())
            # removes the hook from the store's listener list so discarded
            # services do not accumulate dead entries there
            unsub_cell: List[Any] = []

            def _detach(_ref, cell=unsub_cell):
                if cell:
                    try:
                        cell.pop()()
                    except ValueError:
                        pass             # already unsubscribed via close()

            wself = weakref.ref(self, _detach)

            def _hook(kind: str, name: str):
                svc = wself()
                if svc is not None:
                    svc._on_artifact_registered(kind, name)

            unsub_cell.append(catalog.add_invalidation_listener(_hook))
            self._unsubscribe_invalidation = unsub_cell[0]

    def close(self) -> None:
        """Stop the admission loop (if any), drain every in-flight request
        so no ticket is left unresolved, and detach from the catalog's
        invalidation hook.  Garbage collection of an unclosed service also
        stops the loop thread and detaches the hook (weak trampolines +
        finalizer), but only ``close()`` guarantees queued tickets resolve
        — callers holding tickets should close, not drop, the service."""
        self.batcher.close()           # refuse new submits, keep drainable
        if self._loop_finalizer is not None:
            self._loop_finalizer.detach()
            self._loop_finalizer = None
        if self._loop is not None:
            self._loop.stop()          # loop's exit path drains the queue
            self._loop = None
        # catch anything admitted after the loop's final drain (or queued
        # in explicit-flush mode)
        self.admission_tick(force=True)
        for unsub in self._unsub_codegen:
            try:
                unsub()
            except ValueError:
                pass                   # already removed
        self._unsub_codegen = []
        if self._unsubscribe_invalidation is not None:
            try:
                self._unsubscribe_invalidation()
            except ValueError:
                pass
            self._unsubscribe_invalidation = None

    # -- telemetry ------------------------------------------------------------
    def _register_collectors(self) -> None:
        """Pull-time metric sources: every ServiceStats counter plus the
        key cache/admission/tenant gauges, sampled when ``metrics_text()``
        / ``metrics_snapshot()`` is called — zero hot-path cost, and one
        registry unifies what ``cache_info()``/``admission_info()``/
        ``tenant_info()``/``shard_info()`` previously scattered.  The
        collector runs outside the registry lock and takes ``self._lock``
        itself, so lock order is always registry -> service, never the
        reverse (hot-path ``observe`` calls are made outside
        ``self._lock``)."""
        wsvc = weakref.ref(self)
        stat_fields = tuple(f.name for f in dataclasses.fields(ServiceStats))

        def _collect(_w=wsvc):
            svc = _w()
            if svc is None:
                return
            with svc._lock:
                vals = [(f, getattr(svc.stats, f)) for f in stat_fields]
                tenants = {name: (ts.submitted, ts.served, ts.coalesced,
                                  ts.deadline_rejections, ts.queue_wait_ewma)
                           for name, ts in svc._tenant_stats.items()}
                qw = svc._queue_wait_ewma
            for f, v in vals:
                yield (f"repro_{f}_total", "counter", float(v), None)
            yield ("repro_exec_cache_entries", "gauge",
                   float(len(svc._exec_cache)), None)
            yield ("repro_exec_cache_bytes", "gauge",
                   float(svc._exec_cache.bytes_in_use), None)
            if svc._result_cache is not None:
                yield ("repro_result_cache_entries", "gauge",
                       float(len(svc._result_cache)), None)
                yield ("repro_result_cache_bytes", "gauge",
                       float(svc._result_cache.bytes_in_use), None)
            yield ("repro_admission_queue_depth", "gauge",
                   float(len(svc.batcher)), None)
            yield ("repro_admission_queue_depth_high_water", "gauge",
                   float(svc.batcher.depth_high_water), None)
            if qw is not None:
                yield ("repro_queue_wait_ewma_seconds", "gauge", qw, None)
            for name, (sub, served, coal, shed, tqw) in tenants.items():
                labels = {"tenant": name}
                yield ("repro_tenant_submitted_total", "counter",
                       float(sub), labels)
                yield ("repro_tenant_served_total", "counter",
                       float(served), labels)
                yield ("repro_tenant_coalesced_total", "counter",
                       float(coal), labels)
                yield ("repro_tenant_deadline_rejections_total", "counter",
                       float(shed), labels)
                if tqw is not None:
                    yield ("repro_tenant_queue_wait_ewma_seconds", "gauge",
                           tqw, labels)

        self.metrics.add_collector(_collect)

    def _new_trace(self, name: str,
                   ctx: Optional[RequestContext]) -> Any:
        if not self.telemetry:
            return NULL_TRACE
        attrs = {}
        if ctx is not None:
            if ctx.tenant:
                attrs["tenant"] = ctx.tenant
            if ctx.session:
                attrs["session"] = ctx.session
        return Trace(self.clock, next_trace_id(), name=name, attrs=attrs)

    def _finish_trace(self, trace: Any) -> None:
        """Seal a request's trace and retain it in the last-N ring (the
        export buffer behind :meth:`traces` / :meth:`export_traces`)."""
        if trace is None or not trace.enabled \
                or trace.finished is not None:
            return                     # already sealed (idempotent)
        trace.finish()
        self._traces.append(trace)

    def traces(self, n: Optional[int] = None) -> List[Any]:
        """The last-``n`` (default: all retained) finished request traces,
        oldest first."""
        out = list(self._traces)
        return out if n is None else out[-n:]

    def export_traces(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Retained traces as a Chrome-trace/Perfetto JSON object (written
        to ``path`` when given — load it in ``chrome://tracing`` or
        https://ui.perfetto.dev)."""
        return chrome_trace(self.traces(), path=path)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Point-in-time view of every counter/gauge/histogram (hot-path
        writes + pull-time collectors)."""
        return self.metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text-exposition rendering of the registry."""
        return self.metrics.render()

    def explain(self, query: Union[str, Plan],
                tables: Optional[Dict[str, Table]] = None,
                params: Any = None,
                analyze: bool = False) -> "ExplainResult":
        """EXPLAIN [ANALYZE]: the optimized plan this service would serve
        ``query`` with — cache/splice/distribution decisions included —
        and, under ``analyze=True``, measured per-operator wall time and
        row counts.

        The analyze run executes the *same compiled plan* through an
        instrumented twin of the codegen closure whose ``node_hook``
        synchronizes the device around every operator, so each node's
        elapsed time is its
        own — the per-operator sum accounts for the run's end-to-end
        wall time minus only interpreter dispatch.  It is a real
        execution (external runtimes pay their hop), but bypasses
        admission/coalescing — EXPLAIN measures the plan, not the queue."""
        plan = self._to_plan(query)
        bound = None
        if params is not None or plan_params(plan):
            bound = resolve_params(plan, params) or None
            plan, bound = bind_structural_params(plan, bound)
            bound = bound or None
        compiled = self.compile(plan, tables)
        result = ExplainResult(plan=compiled.plan, report=compiled.report,
                               compiled=compiled, analyze=analyze)
        if not analyze:
            return result
        tabs = self._input_tables(compiled, tables)
        if bound:
            tabs["__params__"] = bound
        if compiled.splice is not None:
            ref = compiled.splice
            value = self._result_cache.get(self._result_key(ref)) \
                if self._result_cache is not None else None
            if value is None:
                value = self._materialize(ref)
            tabs[ref.slot] = value
        samples: Dict[str, Tuple[float, int]] = {}

        def hook(nid, node, value, elapsed_s):
            if isinstance(value, Table):
                rows = value.capacity
            elif hasattr(value, "shape") and getattr(value, "shape", ()):
                rows = int(value.shape[0])
            else:
                rows = 1
            prev = samples.get(nid)
            samples[nid] = ((prev[0] if prev else 0.0) + elapsed_s, rows)

        prof_fn = compile_plan(compiled.plan, self.catalog,
                               self.execution_config, node_hook=hook)
        t0 = time.perf_counter()
        _ready(prof_fn(tabs))
        result.total_s = time.perf_counter() - t0
        result.samples = samples
        return result

    # -- invalidation ---------------------------------------------------------
    def _on_artifact_registered(self, kind: str, name: str) -> None:
        """ModelStore hook: free cache entries referencing a re-registered
        model/table.  Content digests already guarantee the *next* lookup
        misses; this reclaims the budget stale entries occupy.

        ``kind='append'`` is the streaming-ingest contract: rows were
        appended to ``name`` with merged column stats *unchanged*, so every
        compiled plan and cached result stays bitwise-valid over the rows
        it covers — version-vector cache keys already route exact lookups
        past pre-append entries, and the delta/staleness tiers put the
        surviving prefix entries to work.  Evicting here would throw away
        exactly the reuse the append path exists to preserve, so the only
        bookkeeping is the append timestamp the freshness SLA reads."""
        if kind == "append":
            self._append_times[name] = self.clock.monotonic()
            with self._lock:
                self.stats.appends_observed += 1
            return
        tag = (kind, name)
        if kind == "table":
            # full re-registration: the append timeline restarts with the
            # new data (a later append to the new table stamps it afresh)
            self._append_times.pop(name, None)
        evicted = len(self._exec_cache.evict_by_tag(tag))
        if self._result_cache is not None:
            evicted += len(self._result_cache.evict_by_tag(tag))
        # Parsed plans resolve columns and models against the catalog, so a
        # re-registration invalidates them wholesale (parsing is cheap; the
        # expensive compile tier has its own content-digest keys).
        self._parse_cache.clear()
        with self._lock:
            self.stats.invalidation_evictions += evicted

    # -- tenants --------------------------------------------------------------
    def _apply_tenant_quota(self, name: str, policy: TenantPolicy) -> None:
        if self._result_cache is not None and (policy.result_cache_entries
                                               or policy.result_cache_bytes):
            self._result_cache.set_tenant_quota(
                name, max_entries=policy.result_cache_entries,
                max_bytes=policy.result_cache_bytes)

    def register_tenant(self, name: str, policy: TenantPolicy) -> None:
        """Register (or update) a tenant's isolation policy.  Takes effect
        on the tenant's next submit — the Batcher reads the same policy
        dict, and cache quotas are enforced on the tenant's next insert."""
        self.tenants[name] = policy
        self._apply_tenant_quota(name, policy)

    def session(self, tenant: Optional[str] = None,
                session_id: Optional[str] = None, priority: int = 0,
                deadline_s: Optional[float] = None,
                max_staleness_s: Optional[float] = None) -> Session:
        """Open a long-lived front-door handle: every ``sql``/``submit``/
        ``predict`` through it carries this tenant/priority/deadline/
        freshness context.  Sessions are free to create and need no
        teardown (all state lives in the service)."""
        return Session(self, tenant=tenant, session_id=session_id,
                       priority=priority, deadline_s=deadline_s,
                       max_staleness_s=max_staleness_s)

    def _tenant_stat(self, tenant: Optional[str]) -> Optional[TenantStats]:
        """Tenant ledger accessor; call while holding ``self._lock``."""
        if tenant is None:
            return None
        ts = self._tenant_stats.get(tenant)
        if ts is None:
            ts = self._tenant_stats[tenant] = TenantStats()
        return ts

    @staticmethod
    def _resolve_ctx(ctx: Optional[RequestContext],
                     tenant: Optional[str], priority: int,
                     deadline_s: Optional[float],
                     max_staleness_s: Optional[float] = None
                     ) -> Optional[RequestContext]:
        """Fold loose kwargs into a context.  Returns ``None`` when the
        caller supplied nothing — the single-tenant path stays ctx-free so
        its behavior (queueing, hooks, stats) is byte-for-byte the
        pre-tenant one."""
        if ctx is not None:
            return ctx
        if tenant is None and not priority and deadline_s is None \
                and max_staleness_s is None:
            return None
        return RequestContext(tenant=tenant, priority=priority,
                              deadline_s=deadline_s,
                              max_staleness_s=max_staleness_s)

    def _is_cold_key(self, batch_key: Any) -> bool:
        """Whether serving this batch key would compile (no executable-
        cache entry yet).  Parameterized batch keys carry a binding
        fingerprint — strip it; bindings share the signature's
        executable, so only the first binding of a signature is cold."""
        key = batch_key
        if isinstance(key, tuple) and len(key) == 3 \
                and key[1] == "__params__":
            key = key[0]
        return self._exec_cache.get(key, count=False) is None

    def _deadline_estimate(self, key: Any,
                           tenant: Optional[str] = None) -> Optional[float]:
        """Calibrated time-to-result estimate for one request of this
        cache key: queue-wait EWMA + the key's execution-time EWMA, or
        ``None`` while either is uncalibrated (cold keys never shed).
        A tenant with its own calibrated queue-wait EWMA uses that instead
        of the global one, so one flooded tenant's backlog neither inflates
        a compliant neighbor's estimate nor hides behind the fleet
        average."""
        with self._lock:
            qw = self._queue_wait_ewma
            if tenant is not None:
                ts = self._tenant_stats.get(tenant)
                if ts is not None and ts.queue_wait_ewma is not None:
                    qw = ts.queue_wait_ewma
            ex = self._exec_ewma.get(key)
        if qw is None or ex is None:
            return None
        return qw + ex

    # -- frontend -----------------------------------------------------------
    def _to_plan(self, query: Union[str, Plan]) -> Plan:
        if isinstance(query, Plan):
            return query
        plan = self._parse_cache.get(query)
        if plan is not None:
            with self._lock:
                self.stats.sql_parse_hits += 1
            return plan
        plan = parse_query(query, self.catalog)
        with self._lock:
            self.stats.sql_parses += 1
        if len(self._parse_cache) >= 1024:
            self._parse_cache.clear()     # text churn: cheap full reset
        self._parse_cache[query] = plan
        return plan

    def _resolve_schema(self, name: str,
                        tables: Optional[Dict[str, Table]]) -> Schema:
        if tables and name in tables:
            return tables[name].schema
        return self.catalog.get_table(name).schema

    def _cache_key(self, plan: Plan,
                   tables: Optional[Dict[str, Table]]) -> Tuple[Tuple, str]:
        sig = plan_signature(plan)
        scans = tuple(sorted(n.attrs["table"] for n in plan.nodes.values()
                             if n.op == "scan"))
        schemas = tuple(_schema_sig(self._resolve_schema(t, tables))
                        for t in scans)
        overridden = tuple(t for t in scans if tables and t in tables)
        # Stats-based pruning bakes catalog column stats into the optimized
        # plan, so the key must track them: re-registering a table with new
        # stats must miss, and caller-supplied tables (whose data the stats
        # say nothing about) compile without stats pruning — see compile().
        stats_fp = None
        if self.optimizer_config.enable_stats_pruning and not overridden:
            from ..core.model_store import content_fingerprint
            stats_fp = content_fingerprint(tuple(
                (t, tuple(sorted(self.catalog.get_stats(t).items())))
                for t in scans))
        return (sig, schemas, overridden, stats_fp,
                self.execution_config.cache_key(), self.jit), sig

    # -- result-cache plumbing ------------------------------------------------
    def _table_version(self, name: str) -> int:
        getter = getattr(self.catalog, "table_version", None)
        return getter(name) if getter is not None else 0

    def _result_key(self, ref: SubplanRef) -> Tuple:
        """The subtree signature says *what* was computed; table versions
        pin *which data* it was computed over; the execution config pins
        the kernel choice (e.g. Pallas vs reference tree-GEMM need not be
        bit-identical)."""
        return (ref.sig,
                tuple((t, self._table_version(t)) for t in ref.scan_tables),
                self.execution_config.cache_key(), self.jit)

    # -- streaming-ingest plumbing -------------------------------------------
    def _version_lineage(self, name: str) -> Tuple[Tuple[int, int], ...]:
        """The catalog's append lineage for ``name``: ``(version, rows)``
        pairs, oldest first, where each version's rows are a *prefix* of
        every later version's (appends never rewrite existing rows).
        Empty for catalogs without streaming ingest."""
        getter = getattr(self.catalog, "version_lineage", None)
        return getter(name) if getter is not None else ()

    def _staleness_budget(self, ctx: Optional[RequestContext]
                          ) -> Optional[float]:
        """Effective freshness SLA for one request: request context ->
        tenant policy -> service-wide admission default, first non-None
        wins.  ``None`` means the request demands the current version."""
        if ctx is not None:
            if ctx.max_staleness_s is not None:
                return ctx.max_staleness_s
            if ctx.tenant is not None:
                policy = self.tenants.get(ctx.tenant)
                if policy is not None \
                        and policy.max_staleness_s is not None:
                    return policy.max_staleness_s
        return self.batcher.config.max_staleness_s

    def _prefix_entry(self, ref: SubplanRef
                      ) -> Optional[Tuple[Tuple, Any, int]]:
        """On an exact result-key miss, look for the same subtree's value
        cached at an *earlier version of the same lineage* — i.e. computed
        over a strict row-prefix of the current table.  Sound because the
        lineage's tail version is required to match the live version (a
        full re-registration resets the lineage, so values from other
        data can never pose as prefixes).  Returns ``(old_key, entry,
        prefix_rows)`` or ``None``; single-scan subtrees only (a multi-
        table subtree's rows have no prefix correspondence)."""
        if self._result_cache is None or len(ref.scan_tables) != 1:
            return None
        (t,) = ref.scan_tables
        lineage = self._version_lineage(t)
        if len(lineage) < 2 or lineage[-1][0] != self._table_version(t):
            return None
        cur_rows = lineage[-1][1]
        cfg_key = self.execution_config.cache_key()
        for version, rows in reversed(lineage[:-1]):
            if rows >= cur_rows:
                continue
            old_key = (ref.sig, ((t, version),), cfg_key, self.jit)
            entry = self._result_cache.entry(old_key)
            if entry is None:
                continue
            try:
                if _rows_of(entry.value) != rows:
                    continue           # no row alignment (e.g. aggregate)
            except (AttributeError, IndexError, TypeError):
                continue
            return old_key, entry, rows
        return None

    def _subplan_ref(self, plan: Plan, nid: str, sig: str) -> SubplanRef:
        nids = subtree_nodes(plan, nid)
        sub = Plan({i: plan.nodes[i].copy() for i in nids}, output=nid)
        scans = _scan_names(plan, nids)
        tags = tuple(("model", m) for m in referenced_models(sub)) \
            + tuple(("table", t) for t in scans)
        return SubplanRef(sig=sig, slot=f"__subplan__{sig[:16]}",
                          subtree_plan=sub, scan_tables=scans, tags=tags,
                          n_nodes=len(nids))

    def _subplan_candidates(self, plan: Plan,
                            overridden: Tuple[str, ...]
                            ) -> List[Tuple[str, int]]:
        """Materializable subtree roots, largest first: deterministic,
        containing at least one expensive (inference/featurization or
        off-process) op, and reading only non-overridden catalog tables."""
        if plan.output is None or self._result_cache is None:
            return []
        out: List[Tuple[str, int]] = []
        for nid in subtree_nodes(plan, plan.output):
            nids = subtree_nodes(plan, nid)
            if len(nids) < 2:
                continue
            nodes = [plan.nodes[i] for i in nids]
            if not any(n.op in _EXPENSIVE_OPS or n.runtime != "native"
                       for n in nodes):
                continue
            scans = _scan_names(plan, nids)
            if any(t in overridden for t in scans):
                continue
            if not is_deterministic_subtree(plan, nid):
                continue
            # A parameterized subtree's value depends on the bound literals,
            # which the result key cannot see — never cache or splice it.
            # Param-free subtrees of a parameterized plan remain fair game.
            if plan_params(plan, nids):
                continue
            out.append((nid, len(nids)))
        out.sort(key=lambda pair: -pair[1])
        return out

    def _store_result(self, ref: SubplanRef, value: Any, cost_s: float,
                      producer: Any, tenant: Optional[str] = None
                      ) -> Optional[int]:
        """``producer`` identifies who materialized the value (the exec-cache
        key of the capturing query, or a rematerialization marker): a
        capture-compiled entry on its warm hit path upgrades to splicing
        only when *someone else* produced the value — upgrading onto its own
        capture would trade the zero-compile warm guarantee for nothing.

        ``cost_s`` from the capture path is the *whole query's* execution
        time — an upper-bound proxy for the subtree (the fused program does
        not time ops individually).  While the entry stays resident the
        proxy stands (the early return below skips re-puts to avoid bytes
        churn on every warm capture run); once the entry cycles through
        eviction, the rematerialization that repopulates it times the
        subtree alone and inserts the tight value.

        Returns how many entries the put evicted, or None when nothing was
        put."""
        if self._result_cache is None:
            return None
        rkey = self._result_key(ref)
        if rkey in self._result_cache:
            return None                  # identical by construction
        evicted = self._result_cache.put(
            rkey, value, cost_s=cost_s,
            tags=ref.tags + (("producer", producer),), tenant=tenant)
        with self._lock:
            self.stats.result_puts += 1
            self.stats.result_evictions += len(evicted)
        return len(evicted)

    def _materialize(self, ref: SubplanRef) -> Any:
        """Execute the subtree plan standalone (result-cache miss after
        eviction/invalidation) and repopulate the cache."""
        if ref._fn is None:
            ref._fn = self._subtree_raw_fn(ref)
        tabs = {t: self.catalog.get_table(t) for t in ref.scan_tables}
        t0 = time.perf_counter()
        value = _ready(ref._fn(tabs))
        self._store_result(ref, value, time.perf_counter() - t0,
                           producer=("rematerialized", ref.sig))
        with self._lock:
            self.stats.rematerializations += 1
        return value

    def _subtree_raw_fn(self, ref: SubplanRef) -> Any:
        """The subtree's closure, compiled lazily and memoized on the ref
        — shared by whole-table rematerialization and the delta tier's
        shape-bucket twins (which wrap it per append bucket)."""
        if ref._raw_fn is None:
            ref._raw_fn = compile_plan(ref.subtree_plan, self.catalog,
                                       self.execution_config)
        return ref._raw_fn

    def _jit(self, fn):
        """Trace accounting around an eager closure: the wrapper counts one
        trace the first time it sees each input signature
        (:func:`_input_signature`) — what a tracing compiler would
        specialize on, and the number the shape-bucket tests bound
        (``jit_traces <= #buckets + #signatures``).  Each wrapper keeps its
        own set, as each compiled executable keeps its own trace cache.
        With ``jit=False`` nothing is wrapped, so nothing counts."""
        if not self.jit:
            return fn
        seen: Set[Tuple] = set()

        def traced(tables, trace=None):
            sig = _input_signature(tables)
            with self._lock:
                fresh = sig not in seen
                if fresh:
                    seen.add(sig)
                    self.stats.jit_traces += 1
            if fresh:
                count_jit_trace()
            return fn(tables, trace=trace)

        return traced

    # -- compile cache -------------------------------------------------------
    def compile(self, query: Union[str, Plan],
                tables: Optional[Dict[str, Table]] = None,
                _key: Optional[Tuple[Tuple, str]] = None,
                ctx: Optional[RequestContext] = None,
                trace: Any = NULL_TRACE) -> CompiledPrediction:
        """Cache lookup; on miss, optimize + codegen once.  ``_key``
        lets flush() reuse the cache key it already computed for grouping
        (key computation hashes the whole plan — not free on the warm
        path).  ``ctx`` informs the append-upgrade decision only (whether
        a freshness SLA could recover a non-row-local subtree)."""
        plan = self._to_plan(query)
        key, sig = _key if _key is not None \
            else self._cache_key(plan, tables)
        hit = self._exec_cache.get(key)
        if hit is not None:
            with self._lock:
                self.stats.cache_hits += 1
            trace.event("executable_cache", result="hit")
            upgraded = self._maybe_upgrade_to_splice(key, hit)
            if upgraded is None:
                upgraded = self._maybe_append_upgrade(key, hit, ctx)
            return upgraded if upgraded is not None else hit
        with self._lock:
            self.stats.cache_misses += 1
        trace.event("executable_cache", result="miss")
        # Compile outside any lock (it is slow); racing misses both compile,
        # last one wins the slot — harmless and rare.
        t0 = time.perf_counter()
        opt_config = self.optimizer_config
        if tables and any(n.attrs["table"] in tables
                          for n in plan.nodes.values() if n.op == "scan"):
            # Caller-supplied tables may violate catalog stats; stats-derived
            # pruning would then silently mispredict — and zone maps
            # collected at registration say nothing about request data, so
            # partition pruning is equally unsound here, as is the
            # distributed rewrite (co-partitioning is a registered-data
            # property).  WHERE-clause-derived pruning stays on (sound for
            # any data).
            opt_config = dataclasses.replace(
                opt_config, enable_stats_pruning=False,
                enable_partition_pruning=False,
                enable_distributed_plan=False)
        with trace.span("optimize"):
            optimized, report = CrossOptimizer(
                self.catalog, opt_config).optimize(plan)
        model_names = report.referenced_models
        full_scans = _scan_names(optimized)
        overridden = key[2]

        # -- result-cache tier: splice a cached subtree, or mark one for
        #    capture so this query populates the cache for later ones.
        capture_ref: Optional[SubplanRef] = None
        splice_ref: Optional[SubplanRef] = None
        exec_plan = optimized
        candidates = self._subplan_candidates(optimized, overridden)
        if candidates:
            sigs = subtree_signatures(optimized)
            for nid, _ in candidates:          # largest shared subtree wins
                ref = self._subplan_ref(optimized, nid, sigs[nid])
                if self._result_key(ref) in self._result_cache:
                    splice_ref = ref
                    exec_plan = self._residual_plan(optimized, nid, ref)
                    report.log("result_cache",
                               f"spliced cached subtree {ref.describe()}")
                    break
            if splice_ref is None:
                # Prefer a proper subtree over the whole plan, and a root
                # below the alias-bearing cosmetics: rename/project nodes
                # embed output aliases in their attrs, so capturing above
                # them would make `... AS score` and `... AS s` miss each
                # other even though their inference prefixes are identical.
                # Fall back progressively when the query *is* the chain.
                proper = [c for c in candidates if c[0] != optimized.output]
                aliased = ("rename", "project")
                alias_free = [c for c in proper
                              if optimized.nodes[c[0]].op not in aliased]
                pick = (alias_free or proper or candidates)[0]
                capture_ref = self._subplan_ref(optimized, pick[0],
                                                sigs[pick[0]])
                report.log("result_cache",
                           f"capturing subtree {capture_ref.describe()}")

        with trace.span("codegen"):
            raw_fn = compile_plan(exec_plan, self.catalog,
                                  self.execution_config,
                                  capture=capture_ref.subtree_plan.output
                                  if capture_ref is not None else None)
            fn = self._jit(raw_fn)
        scans = _scan_names(exec_plan)
        chunk_table = None
        if len(scans) == 1 and all(n.op in _ROW_LOCAL_OPS
                                   for n in exec_plan.nodes.values()):
            chunk_table = scans[0]
        dist = None
        if splice_ref is None:
            dist = self._distributed_spec(exec_plan, overridden, raw_fn)
        compile_time = time.perf_counter() - t0
        compiled = CompiledPrediction(
            key=key, signature=sig, plan=exec_plan, report=report, fn=fn,
            scan_tables=scans, chunk_table=chunk_table,
            compile_time_s=compile_time, model_names=model_names,
            capture=capture_ref, splice=splice_ref, raw_fn=raw_fn,
            catalog_versions=tuple((t, self._table_version(t))
                                   for t in full_scans),
            dist=dist)
        tags = tuple(("model", m) for m in model_names) \
            + tuple(("table", t) for t in full_scans)
        evicted = self._exec_cache.put(
            key, compiled, cost_s=compile_time,
            nbytes=_artifact_nbytes(optimized), tags=tags)
        with self._lock:
            self.stats.evictions += len(evicted)
        if self.telemetry:             # outside self._lock by construction
            self.metrics.observe("repro_compile_seconds", compile_time)
        entry = self._exec_cache.entry(key)
        # max_cache_entries=0 means "no caching": the fresh compile was
        # evicted immediately above, so fall back to it.
        return entry.value if entry is not None else compiled

    def _distributed_spec(self, exec_plan: Plan,
                          overridden: Tuple[str, ...],
                          raw_fn: Any) -> Optional[DistributedSpec]:
        """Derive the local/global split for a distributed-rewritten plan,
        re-verifying partition-locality on the *final* optimized plan (the
        rule marked an earlier rewrite stage; later rules only ever turn
        model ops into row-local LA forms or drop joins, but re-deriving
        costs little and can never be stale).  Returns ``None`` when the
        plan is not distributable — execution then falls back to the
        whole-table tier, which is always correct."""
        if not self.execution_config.sharded or overridden:
            return None
        from ..core.rules.distributed_plan import (local_info,
                                                   two_phase_candidates)
        nodes = exec_plan.nodes.values()
        has_join = any(n.op == "join" and (n.attrs.get("partition_wise")
                                           or n.attrs.get("exchange"))
                       for n in nodes)
        has_agg = any(n.op == "group_agg" and n.attrs.get("two_phase")
                      for n in nodes)
        if not has_join and not has_agg:
            return None

        def stage_scans(local_plan: Plan, anchor: str) -> Tuple[str, ...]:
            scans = sorted({n.attrs["table"]
                            for n in local_plan.nodes.values()
                            if n.op == "scan"})
            return (anchor,) + tuple(t for t in scans if t != anchor)

        def stage_joins(local_plan: Plan) -> int:
            return sum(1 for n in local_plan.nodes.values()
                       if n.op == "join" and n.attrs.get("partition_wise"))

        if has_agg:
            gids = two_phase_candidates(exec_plan, self.catalog)
            if not gids:
                return None
            stages: List[AggStage] = []
            residual = exec_plan.copy()
            for i, gid in enumerate(gids):
                g = exec_plan.nodes[gid]
                info = local_info(exec_plan, g.inputs[0], self.catalog)
                if info is None:
                    return None
                anchor, _intact, exch_join = info
                exchange = None
                if exch_join is not None:
                    exchange = self._exchange_spec(exec_plan, exch_join)
                    if exchange is None:
                        return None  # shuffle disabled or mark went stale
                nids = subtree_nodes(exec_plan, g.inputs[0])
                local_plan = Plan(
                    {n2: exec_plan.nodes[n2].copy() for n2 in nids},
                    output=g.inputs[0])
                head = Node(op="partial_agg", category=g.category,
                            inputs=[local_plan.output],
                            attrs={"key": g.attrs.get("key"),
                                   "aggs": dict(g.attrs["aggs"]),
                                   "num_groups": g.attrs.get("num_groups")},
                            out_kind="table")
                local_plan.output = local_plan.add(head)
                # keep the historical slot name for the single-agg shape
                slot = "__combined__" if len(gids) == 1 \
                    else f"__combined_{i}__"
                leaf = Node(op="materialized", category=g.category,
                            inputs=[],
                            attrs={"slot": slot,
                                   "sig": f"two_phase_combined_{i}"},
                            out_kind=g.out_kind)
                residual.replace(gid, leaf)
                stages.append(AggStage(
                    key=g.attrs.get("key"), aggs=dict(g.attrs["aggs"]),
                    slot=slot, anchor=anchor,
                    part_tables=stage_scans(local_plan, anchor),
                    local_plan=local_plan,
                    local_raw_fn=compile_plan(local_plan, self.catalog,
                                              self.execution_config),
                    local_sig=plan_signature(local_plan),
                    n_joins=stage_joins(local_plan), exchange=exchange))
            residual.prune_dead()
            # tiny (num_groups rows): unwrapped, so it counts no trace
            global_fn = compile_plan(residual, self.catalog,
                                     self.execution_config)
            part_tables = tuple(dict.fromkeys(
                t for s in stages for t in s.part_tables))
            first = stages[0]
            return DistributedSpec(
                anchor=first.anchor, part_tables=part_tables,
                local_plan=first.local_plan,
                local_raw_fn=first.local_raw_fn,
                local_sig=first.local_sig, n_joins=first.n_joins,
                stages=tuple(stages), global_fn=global_fn)

        info = local_info(exec_plan, exec_plan.output, self.catalog)
        if info is None:
            return None              # join marked but plan not fully local
        anchor, _intact, exch_join = info
        exchange = None
        if exch_join is not None:
            exchange = self._exchange_spec(exec_plan, exch_join)
            if exchange is None:
                return None
        local_plan = exec_plan
        local_raw_fn = raw_fn        # shares the (capture-aware) closure
        return DistributedSpec(
            anchor=anchor,
            part_tables=stage_scans(local_plan, anchor),
            local_plan=local_plan, local_raw_fn=local_raw_fn,
            local_sig=plan_signature(local_plan),
            n_joins=stage_joins(local_plan), exchange=exchange)

    def _exchange_spec(self, plan: Plan,
                       join_id: str) -> Optional[ExchangeSpec]:
        """Derive the shuffle identity for the exchange-marked join
        ``join_id``: the (intact) key column and the two partitioned
        tables to bucket.  ``None`` — which sends the whole plan to
        whole-table execution — when the exchange knob is off or the mark
        no longer matches the final plan's shape."""
        if not getattr(self.execution_config, "shard_exchange", True):
            return None
        from ..core.rules.distributed_plan import local_info
        join = plan.nodes.get(join_id)
        if join is None or join.op != "join" \
                or not join.attrs.get("exchange"):
            return None
        left = local_info(plan, join.inputs[0], self.catalog)
        right = local_info(plan, join.inputs[1], self.catalog)
        if left is None or right is None \
                or left[2] is not None or right[2] is not None:
            return None
        on = join.attrs["on"]
        if on not in left[1] or on not in right[1]:
            return None
        # the shuffle executor buckets exactly two tables: each side must
        # be a single-scan chain (a nested partition-wise join below an
        # exchange would need its own aligned gather per bucket)
        for nid, table in ((join.inputs[0], left[0]),
                           (join.inputs[1], right[0])):
            scans = {plan.nodes[i].attrs["table"]
                     for i in subtree_nodes(plan, nid)
                     if plan.nodes[i].op == "scan"}
            if scans != {table}:
                return None
        return ExchangeSpec(on=on, left=left[0], right=right[0],
                            join_id=join_id)

    def _maybe_upgrade_to_splice(self, key: Tuple, hit: CompiledPrediction
                                 ) -> Optional[CompiledPrediction]:
        """Warm-hit path: a capture-compiled entry whose subtree was since
        materialized by a *different* query recompiles to its residual once,
        so it too stops paying for inference.  Entries whose cached value
        they produced themselves stay fused (keeps the zero-compile warm
        guarantee for the producer)."""
        if hit.capture is None or self._result_cache is None:
            return None
        ref = hit.capture
        entry = self._result_cache.entry(self._result_key(ref))
        if entry is None or ("producer", key) in entry.tags:
            return None
        return self._upgrade_to_splice(key, hit, ref, "splice_upgrades")

    def _maybe_append_upgrade(self, key: Tuple, hit: CompiledPrediction,
                              ctx: Optional[RequestContext] = None
                              ) -> Optional[CompiledPrediction]:
        """Warm-hit path under streaming ingest: a capture-compiled entry
        whose own cached subtree value went stale because its table *grew*
        (the exact result key misses, but a strict prefix of the same
        lineage is resident) re-wires to its residual once.  The spliced
        execution then recovers the value incrementally — delta rows only
        for row-local subtrees, or the pre-append snapshot within the
        freshness SLA — instead of re-running the fused whole-table
        program over rows it already processed.  The producer-stays-fused
        guarantee is untouched: while the exact value is resident this is
        a no-op, so append-free workloads never see it."""
        if hit.capture is None or self._result_cache is None:
            return None
        ref = hit.capture
        if self._result_cache.entry(self._result_key(ref)) is not None:
            return None                # exact value resident: stay fused
        if self._prefix_entry(ref) is None:
            return None
        row_local = all(n.op in _ROW_LOCAL_OPS
                        for n in ref.subtree_plan.nodes.values())
        if not row_local and self._staleness_budget(ctx) is None:
            return None     # neither delta nor stale serve could recover it
        return self._upgrade_to_splice(key, hit, ref, "append_upgrades")

    def _upgrade_to_splice(self, key: Tuple, hit: CompiledPrediction,
                           ref: SubplanRef, stat_name: str
                           ) -> CompiledPrediction:
        t0 = time.perf_counter()
        residual = self._residual_plan(hit.plan, ref.subtree_plan.output, ref)
        raw_fn = compile_plan(residual, self.catalog, self.execution_config)
        fn = self._jit(raw_fn)
        hit.report.log("result_cache",
                       f"upgraded to spliced {ref.describe()}")
        compiled = CompiledPrediction(
            key=key, signature=hit.signature, plan=residual,
            report=hit.report, fn=fn, scan_tables=_scan_names(residual),
            chunk_table=None,
            compile_time_s=hit.compile_time_s + time.perf_counter() - t0,
            model_names=hit.model_names, capture=None, splice=ref,
            raw_fn=raw_fn)
        # The entry may have vanished between get() and here (concurrent
        # invalidation/eviction); rebuild tags + bytes from the hit rather
        # than re-inserting an untagged, unbudgeted executable.
        old = self._exec_cache.entry(key)
        tags = old.tags if old is not None else (
            tuple(("model", m) for m in hit.model_names)
            + tuple(("table", t) for t in _scan_names(hit.plan)))
        nbytes = old.nbytes if old is not None \
            else _artifact_nbytes(hit.plan)
        evicted = self._exec_cache.put(
            key, compiled, cost_s=compiled.compile_time_s,
            nbytes=nbytes, tags=tags)
        with self._lock:
            setattr(self.stats, stat_name,
                    getattr(self.stats, stat_name) + 1)
            self.stats.evictions += len(evicted)
        return compiled

    def _residual_plan(self, plan: Plan, nid: str, ref: SubplanRef) -> Plan:
        """Replace the subtree rooted at ``nid`` with a ``materialized``
        leaf reading the cached value from ``ref.slot``."""
        root = plan.nodes[nid]
        residual = plan.copy()
        leaf = Node(op="materialized", category=root.category, inputs=[],
                    attrs={"slot": ref.slot, "sig": ref.sig},
                    out_kind=root.out_kind)
        residual.replace(nid, leaf)
        residual.prune_dead()
        return residual

    def cache_info(self) -> Dict[str, Any]:
        with self._lock:
            info = {"entries": len(self._exec_cache),
                    "bytes": self._exec_cache.bytes_in_use,
                    "hits": self.stats.cache_hits,
                    "misses": self.stats.cache_misses,
                    "evictions": self.stats.evictions,
                    "invalidation_evictions":
                        self.stats.invalidation_evictions}
            if self._result_cache is not None:
                info.update({
                    "result_entries": len(self._result_cache),
                    "result_bytes": self._result_cache.bytes_in_use,
                    "result_hits": self.stats.result_hits,
                    "result_misses": self.stats.result_misses,
                    "result_evictions": self.stats.result_evictions,
                })
            return info

    def admission_info(self) -> Dict[str, Any]:
        """Continuous-batching ledger: coalesce rate, bucket hit rate, and
        p50/p95 queue latency (seconds each admitted request waited between
        ``submit`` and its group's release, measured on the injected
        clock)."""
        depth = len(self.batcher)
        with self._lock:
            s = self.stats
            lats = sorted(self._queue_latencies)
            served = s.batch_executions + s.coalesced_requests
            bucket_lookups = s.bucket_hits + s.bucket_compiles

            def pct(p: float) -> float:
                if not lats:
                    return 0.0
                return lats[min(len(lats) - 1, round(p * (len(lats) - 1)))]

            return {
                "queue_depth": depth,
                # flush window currently in force (== the configured
                # constant unless adaptive_latency slides it between the
                # min/max budgets on the queue-depth EWMA)
                "latency_budget_s": self.batcher.effective_latency_budget(),
                "queue_depth_ewma": self.batcher.queue_depth_ewma,
                "queue_depth_high_water": self.batcher.depth_high_water,
                "submitted": s.submitted,
                "served": served,
                "coalesce_rate": s.coalesced_requests / served
                if served else 0.0,
                "bucket_compiles": s.bucket_compiles,
                "bucket_hit_rate": s.bucket_hits / bucket_lookups
                if bucket_lookups else 0.0,
                "jit_traces": s.jit_traces,
                "queue_p50_ms": pct(0.50) * 1e3,
                "queue_p95_ms": pct(0.95) * 1e3,
                "deadline_flushes": s.deadline_flushes,
                "size_flushes": s.size_flushes,
                "drain_flushes": s.drain_flushes,
                "queue_rejections": s.queue_rejections,
                "deadline_rejections": s.deadline_rejections,
                "compile_deferrals": self.batcher.compile_deferrals,
                "background_loop": self._loop is not None
                and self._loop.running,
                "loop_error": self._loop.last_error
                if self._loop is not None else None,
            }

    def tenant_info(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant observability: queue depth, drain weight, p50/p95
        queue latency (injected-clock seconds -> ms), coalesce rate,
        backpressure rejections, and the tenant's slice of the result
        cache (resident entries/bytes + quota evictions).  Keys are tenant
        names; the ``tenant=None`` default path is deliberately absent —
        its numbers are the service-wide ``admission_info()``."""
        depths = self.batcher.depths()
        rejections = dict(self.batcher.rejections)
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            names = (set(self.tenants) | set(self._tenant_stats)
                     | {t for t in depths if t is not None}
                     | {t for t in rejections if t is not None})
            for name in sorted(names):
                ts = self._tenant_stats.get(name) or TenantStats()
                policy = self.tenants.get(name)
                lats = sorted(ts.latencies)

                def pct(p: float) -> float:
                    if not lats:
                        return 0.0
                    return lats[min(len(lats) - 1,
                                    round(p * (len(lats) - 1)))]

                usage = (self._result_cache.tenant_usage(name)
                         if self._result_cache is not None
                         else {"entries": 0, "bytes": 0, "evictions": 0})
                out[name] = {
                    "queue_depth": depths.get(name, 0),
                    "weight": policy.weight if policy is not None else 1.0,
                    "max_queue": policy.max_queue
                    if policy is not None else None,
                    "submitted": ts.submitted,
                    "served": ts.served,
                    "coalesced": ts.coalesced,
                    "coalesce_rate": ts.coalesced / ts.served
                    if ts.served else 0.0,
                    "rejections": rejections.get(name, 0),
                    "deadline_rejections": ts.deadline_rejections,
                    "queue_p50_ms": pct(0.50) * 1e3,
                    "queue_p95_ms": pct(0.95) * 1e3,
                    "result_cache_entries": usage["entries"],
                    "result_cache_bytes": usage["bytes"],
                    "result_cache_evictions": usage["evictions"],
                }
        return out

    # -- execution -----------------------------------------------------------
    def _input_tables(self, compiled: CompiledPrediction,
                      tables: Optional[Dict[str, Table]]
                      ) -> Dict[str, Table]:
        tabs: Dict[str, Table] = {}
        for name in compiled.scan_tables:
            if tables and name in tables:
                tabs[name] = tables[name]
            else:
                tabs[name] = self.catalog.get_table(name)
        return tabs

    def _execute(self, compiled: CompiledPrediction,
                 tables: Optional[Dict[str, Table]],
                 store_capture: bool = True,
                 params: Optional[Dict[str, Any]] = None,
                 tenant: Optional[str] = None,
                 ctx: Optional[RequestContext] = None,
                 trace: Any = NULL_TRACE) -> Any:
        """``store_capture=False`` executes a capture-compiled plan without
        populating the result cache — used when the inputs are not the
        catalog tables the cache key would claim (stacked micro-batches).
        ``params`` rides along in the tables dict under the reserved
        ``__params__`` slot (bound inside the closure, so every binding
        shares one executable); parameterized serves skip the sharded tier
        (the partition executor stacks tables, not binding dicts)."""
        tabs = self._input_tables(compiled, tables)
        if params:
            tabs["__params__"] = params
        compiled.serves += 1
        with self._lock:
            self.stats.batch_executions += 1
        if compiled.splice is not None:
            out = self._execute_spliced(compiled, tabs, ctx=ctx,
                                        trace=trace)
        elif not params and self._should_shard(compiled, tables):
            out = self._execute_sharded(compiled, tabs, store_capture,
                                        tenant=tenant, trace=trace)
        elif (self.chunk_rows and compiled.chunk_table is not None
                and tabs[compiled.chunk_table].capacity > self.chunk_rows):
            out = self._execute_chunked(compiled, tabs, store_capture,
                                        tenant=tenant, trace=trace)
        else:
            out = self._execute_whole(compiled, tabs, store_capture,
                                      tenant=tenant, trace=trace)
        # A served result is a *ready* result: the ticket resolves, and
        # the caller's clock stops, only after the device finished it.
        return _ready(out)

    def _execute_whole(self, compiled: CompiledPrediction,
                       tabs: Dict[str, Table],
                       store_capture: bool = True,
                       tenant: Optional[str] = None,
                       trace: Any = NULL_TRACE) -> Any:
        """One whole-input execution of the fused program (the base tier;
        also the fallback when a sharded execution loses its partitioning
        mid-flight)."""
        resident = self._capture_resident(compiled, trace)
        t0 = time.perf_counter()
        raw = _ready(compiled.fn(tabs, trace=trace))
        if compiled.capture is None:
            return raw
        out, captured = raw
        self._store_capture(compiled, captured, time.perf_counter() - t0,
                            store_capture, resident, tenant, trace)
        return out

    def _capture_resident(self, compiled: CompiledPrediction,
                          trace: Any) -> bool:
        """Whether a capture-compiled plan's subtree value is in the result
        cache before this execution (read only for the trace)."""
        return (trace.enabled and compiled.capture is not None
                and self._result_key(compiled.capture) in self._result_cache)

    def _store_capture(self, compiled: CompiledPrediction, captured: Any,
                       cost_s: float, store_capture: bool, resident: bool,
                       tenant: Optional[str], trace: Any) -> None:
        """Offer a capture-compiled execution's subtree value to the result
        cache, and mark the execution with a ``result_capture`` event:
        whether the value was ``resident`` before it ran, whether it was
        ``put``, and how many entries the put ``evicted``."""
        evicted = None
        if store_capture:
            evicted = self._store_result(compiled.capture, captured, cost_s,
                                         producer=compiled.key, tenant=tenant)
        trace.event("result_capture", resident=resident,
                    put=evicted is not None, evicted=evicted or 0)

    # -- partition-parallel (sharded) tier ------------------------------------
    def _should_shard(self, compiled: CompiledPrediction,
                      tables: Optional[Dict[str, Table]]) -> bool:
        """Sharded execution applies to plans the distributed_plan rule
        rewrote (partition-wise joins / two-phase aggregation, carried in
        ``compiled.dist``) and to row-local single-scan plans over a
        *partitioned, non-overridden* catalog table.  Spliced plans are
        excluded (a materialized slot's rows would have to be re-aligned
        with each morsel's partition rows); everything else — admission
        coalescing, result-cache producers for unsharded services,
        invalidation — works unchanged around this branch."""
        if not self.execution_config.sharded:
            return False
        if compiled.splice is not None:
            return False
        getter = getattr(self.catalog, "get_partitioned", None)
        if getter is None:
            return False
        if compiled.dist is not None:
            # distributed plans compile only against catalog data (the
            # rule is off for override requests); the guard is belt and
            # braces for hand-constructed CompiledPredictions
            return not (tables
                        and any(t in tables for t in compiled.scan_tables))
        if compiled.chunk_table is None:
            return False
        if tables and compiled.chunk_table in tables:
            return False            # request-supplied data: no zone maps
        return getter(compiled.chunk_table) is not None

    def _shard_executor(self) -> ShardedExecutor:
        if self._shard_exec is None:
            self._shard_exec = ShardedExecutor(
                devices=self.execution_config.shard_devices,
                home=getattr(self.catalog, "device", None) or "cpu")
        return self._shard_exec

    def _execute_sharded(self, compiled: CompiledPrediction,
                         tabs: Dict[str, Table],
                         store_capture: bool = True,
                         tenant: Optional[str] = None,
                         trace: Any = NULL_TRACE) -> Any:
        """Place the plan's surviving partitions across the devices and
        run the fused program per morsel (``serve/sharded.py``).  The
        partitioned table is re-read from the catalog (not the tabs dict)
        so partition ranges and data always describe the same object.
        Capture-compiled plans keep their capture: the executor reassembles
        per-morsel capture slices in partition order — bit-exact the
        whole-table subtree value when every partition was scanned — and
        the result cache is populated exactly as on the whole-table path.
        When zone maps pruned partitions (or the pruned set was stale) the
        reassembled capture covers only the surviving rows, which is *not*
        the value the result-cache key claims, so it is discarded."""
        if compiled.dist is not None:
            return self._execute_distributed(compiled, tabs, store_capture,
                                             trace=trace)
        cfg = self.execution_config
        name = compiled.chunk_table
        pt = self.catalog.get_partitioned(name)
        if pt is None:
            # partitioning vanished between _should_shard and here (the
            # table was re-registered unpartitioned): serve whole-table
            return self._execute_whole(compiled, tabs, store_capture,
                                       tenant=tenant, trace=trace)
        executor = self._shard_executor()
        scan = next(n for n in compiled.plan.nodes.values()
                    if n.op == "scan")
        surviving = scan.attrs.get("partitions")
        # pt carries its own registration stamp (set under the store lock),
        # so this check cannot be fooled by a re-registration interleaving
        # separate catalog reads: stale stamp -> the pruned set describes
        # other data -> scan every partition of the pt we actually hold —
        # always sound, pruning is only ever an optimization
        version_fresh = (name, pt.version) in compiled.catalog_versions
        if surviving is None or not version_fresh \
                or any(i >= pt.n_partitions for i in surviving):
            surviving = tuple(range(pt.n_partitions))
        parts = [pt.partitions[i] for i in surviving]
        placement = executor.plan(
            parts, min_bucket_rows=cfg.shard_min_bucket_rows,
            morsel_rows=cfg.shard_morsel_rows)
        twin, fresh, tags = self._sharded_executable(
            compiled, placement.bucket_rows)
        want_capture = compiled.capture is not None
        t0 = time.perf_counter()
        out = _ready(executor.execute(twin.fn, pt, name, parts, placement,
                                      capture=want_capture, trace=trace))
        elapsed = time.perf_counter() - t0
        if want_capture:
            out, captured = out
            if (store_capture and version_fresh
                    and len(parts) == pt.n_partitions):
                self._store_result(compiled.capture, captured, elapsed,
                                   producer=compiled.key, tenant=tenant)
        twin.serves += 1
        self._record_twin_cost(twin, fresh, tags, elapsed)
        with self._lock:
            self.stats.sharded_executions += 1
            self.stats.shard_waves += placement.n_waves
            self.stats.partitions_scanned += len(parts)
            self.stats.partitions_pruned += pt.n_partitions - len(parts)
        return out

    def _execute_distributed(self, compiled: CompiledPrediction,
                             tabs: Dict[str, Table],
                             store_capture: bool = True,
                             trace: Any = NULL_TRACE) -> Any:
        """Partition-wise join / two-phase aggregation execution: place
        the anchor table's surviving partitions across the devices, gather
        each join side's *aligned* partitions per morsel, run the local
        program, and — for two-phase aggregation — fold the per-morsel
        partial states before the global residual.

        Every partitioned table the local plan reads is version-checked
        against the compile-time snapshot; any mismatch (a re-registration
        racing the invalidation hook) voids both the pruned-partition set
        *and* the co-partitioning proof, so the serve falls back to
        whole-table execution — pruning and distribution are only ever
        optimizations.  One exception earns a cheaper path: a mismatch
        that the catalog's *append lineage* explains (rows were appended;
        every pre-append partition is untouched) keeps two-phase
        aggregation incremental — the cached prefix partial-state folds
        with fresh partials over only the delta partitions (partial states
        are additive by construction, see ``merge_partial_states``)."""
        dist = compiled.dist
        getter = getattr(self.catalog, "get_partitioned", None)
        pts = {}
        stale: Set[str] = set()
        for t in dist.part_tables:
            pt = getter(t) if getter is not None else None
            if pt is None:
                return self._execute_whole(compiled, tabs, store_capture,
                                           trace=trace)
            if (t, pt.version) not in compiled.catalog_versions:
                stale.add(t)
            pts[t] = pt
        if dist.stages:
            # Pre-validate every stage before running any: a stage touching
            # a stale table must be recoverable from a cached prefix state
            # over only its delta partitions, else the whole plan takes the
            # sound whole-table fallback (partial work would be wasted).
            preps: Dict[int, Tuple] = {}
            for i, stage in enumerate(dist.stages):
                if not any(t in stale for t in stage.part_tables):
                    continue
                prep = self._agg_delta_prep(stage, pts)
                if prep is None:
                    with self._lock:
                        self.stats.delta_fallbacks += 1
                    trace.event("delta_fallback", slot=stage.slot)
                    return self._execute_whole(compiled, tabs,
                                               store_capture, trace=trace)
                preps[i] = prep
            slots: Dict[str, Any] = {}
            for i, stage in enumerate(dist.stages):
                prep = preps.get(i)
                pt = pts[stage.anchor]
                # Capture the merged partial state whenever this stage's
                # serve covers the whole table (no pruning, single-table
                # stage): the state is what a future append extends.
                keep_state = self._result_cache is not None \
                    and self._stage_state_eligible(stage, pt)
                state_box: List[Any] = []
                prefix_state = prep[1].value if prep is not None else None

                def combine(partials, _s=stage, _pre=prefix_state,
                            _keep=keep_state, _box=state_box):
                    parts = list(partials) if _pre is None \
                        else [_pre] + list(partials)
                    if _keep:
                        _box.append(merge_partial_states(parts, _s.key,
                                                         _s.aggs))
                    return combine_partials(parts, _s.key, _s.aggs)

                if stage.exchange is not None:
                    ok, combined, n_units = self._run_exchange(
                        compiled, stage, pts, combine=combine, trace=trace)
                    if not ok:     # cost gate: shuffle loses to whole-table
                        return self._execute_whole(compiled, tabs,
                                                   store_capture, trace=trace)
                else:
                    combined, n_units = self._run_partition_wise(
                        compiled, stage, pts, combine=combine,
                        surviving=prep[3] if prep is not None else None,
                        trace=trace)
                slots[stage.slot] = combined
                if keep_state and state_box:
                    skey = self._agg_state_key(stage, stage.anchor,
                                               pt.version)
                    if skey not in self._result_cache:
                        evicted = self._result_cache.put(
                            skey, _ready(state_box[0]),
                            tags=(("table", stage.anchor),))
                        with self._lock:
                            self.stats.result_puts += 1
                            self.stats.result_evictions += len(evicted)
                    if prep is not None:
                        popped = self._result_cache.pop(prep[2])
                        with self._lock:
                            if popped is not None:
                                self.stats.prefix_supersedes += 1
                if prep is not None:
                    with self._lock:
                        self.stats.delta_serves += 1
                        self.stats.delta_rows_scanned += \
                            pt.table.capacity - prep[0]
                    trace.event("delta_agg", slot=stage.slot,
                                prefix_rows=prep[0],
                                delta_rows=pt.table.capacity - prep[0])
                with self._lock:
                    self.stats.shard_agg_combines += 1
                    self.stats.shard_partial_aggs += n_units
            with trace.span("combine_global", stages=len(dist.stages)):
                out = dist.global_fn(slots)
            with self._lock:
                self.stats.sharded_executions += 1
                if any(s.n_joins or s.exchange for s in dist.stages):
                    self.stats.shard_join_executions += 1
            return out
        if stale:
            # join-only plans have no additive state to extend: appends
            # void the co-partitioning proof like any re-registration
            with self._lock:
                self.stats.delta_fallbacks += 1
            return self._execute_whole(compiled, tabs, store_capture,
                                       trace=trace)
        # join-only: the local plan IS the whole plan; drop the capture
        # half when present (a shuffled/sharded capture is not the value
        # the result-cache key would claim)
        unwrap = (lambda raw: raw[0]) if compiled.capture is not None \
            else None
        if dist.exchange is not None:
            ok, out, _units = self._run_exchange(compiled, dist, pts,
                                                 unwrap=unwrap, trace=trace)
            if not ok:
                return self._execute_whole(compiled, tabs, store_capture,
                                           trace=trace)
        else:
            out, _units = self._run_partition_wise(compiled, dist, pts,
                                                   unwrap=unwrap,
                                                   trace=trace)
        with self._lock:
            self.stats.sharded_executions += 1
            if dist.n_joins or dist.exchange is not None:
                self.stats.shard_join_executions += 1
        return out

    def _agg_state_key(self, stage: AggStage, t: str,
                       version: int) -> Tuple:
        """Result-cache key of one stage's merged *partial state* (still
        mergeable, unlike the finalized combined table) over ``t`` at
        ``version`` — what a later append folds its delta partials into."""
        return ("agg_state", stage.local_sig, (t, version),
                self.execution_config.cache_key(), self.jit)

    def _stage_state_eligible(self, stage: AggStage, pt: Any) -> bool:
        """Whether this serve's merged partial state would cover the whole
        table — the precondition for caching it as an append-extensible
        prefix.  Single-table stages only (a join side has no row-prefix
        correspondence), with no zone-map pruning in force (a pruned
        state would silently miss rows a later delta never revisits)."""
        if (stage.exchange is not None or stage.n_joins
                or stage.part_tables != (stage.anchor,)):
            return False
        scan = next(n for n in stage.local_plan.nodes.values()
                    if n.op == "scan" and n.attrs["table"] == stage.anchor)
        surviving = scan.attrs.get("partitions")
        return (surviving is None
                or any(i >= pt.n_partitions for i in surviving)
                or len(surviving) == pt.n_partitions)

    def _agg_delta_prep(self, stage: AggStage, pts: Dict[str, Any]
                        ) -> Optional[Tuple[int, Any, Tuple, Tuple]]:
        """Whether one stale-anchored stage can run incrementally: its
        (single) anchor's growth is explained by the append lineage, a
        prefix partial-state is cached at some earlier lineage version,
        and the partitions past that prefix tile exactly the appended
        rows (``PartitionedTable.append`` guarantees appends open new
        partitions at the old boundary).  Returns ``(prefix_rows,
        state_entry, old_state_key, delta_partition_indices)`` or
        ``None`` (-> whole-table fallback)."""
        if (stage.exchange is not None or stage.n_joins
                or stage.part_tables != (stage.anchor,)
                or self._result_cache is None):
            return None
        t = stage.anchor
        pt = pts[t]
        lineage = self._version_lineage(t)
        if len(lineage) < 2 or lineage[-1][0] != pt.version:
            return None
        cur_rows = lineage[-1][1]
        for version, rows in reversed(lineage[:-1]):
            if rows >= cur_rows:
                continue
            entry = self._result_cache.entry(
                self._agg_state_key(stage, t, version))
            if entry is None:
                continue
            delta = tuple(p.index for p in pt.partitions
                          if p.start >= rows)
            if not delta or pt.partitions[delta[0]].start != rows:
                return None    # prefix boundary straddles a partition
            return rows, entry, self._agg_state_key(stage, t, version), \
                delta
        return None

    def _run_partition_wise(self, compiled: CompiledPrediction, stage: Any,
                            pts: Dict[str, Any],
                            combine: Optional[Any] = None,
                            unwrap: Optional[Any] = None,
                            surviving: Optional[Tuple[int, ...]] = None,
                            trace: Any = NULL_TRACE
                            ) -> Tuple[Any, int]:
        """Run one local program (a :class:`DistributedSpec` or one
        :class:`AggStage` — both carry anchor/part_tables/local_*) over
        the anchor's surviving partitions with aligned co-partitioned
        sides.  ``surviving`` overrides the compile-time pruned set (the
        delta tier passes exactly the appended partitions).  Returns
        ``(output, #morsels)``."""
        cfg = self.execution_config
        executor = self._shard_executor()
        anchor_pt = pts[stage.anchor]
        if surviving is None:
            scan = next(n for n in stage.local_plan.nodes.values()
                        if n.op == "scan"
                        and n.attrs["table"] == stage.anchor)
            surviving = scan.attrs.get("partitions")
        if surviving is None \
                or any(i >= anchor_pt.n_partitions for i in surviving):
            surviving = tuple(range(anchor_pt.n_partitions))
        parts = [anchor_pt.partitions[i] for i in surviving]
        placement = executor.plan(
            parts, min_bucket_rows=cfg.shard_min_bucket_rows,
            morsel_rows=cfg.shard_morsel_rows)
        sides = {t: (pts[t], side_bucket_rows(placement,
                                              pts[t].partitions,
                                              cfg.shard_min_bucket_rows))
                 for t in stage.part_tables[1:]}
        side_buckets = tuple(sorted((t, b) for t, (_pt, b)
                                    in sides.items()))
        twin, fresh, tags = self._twin_executable(
            compiled,
            sharded_signature(stage.local_sig, placement.bucket_rows,
                              executor.mesh_shape, side_buckets),
            placement.bucket_rows, "shard_hits", "shard_compiles",
            raw_fn=stage.local_raw_fn)
        t0 = time.perf_counter()
        out = _ready(executor.execute(twin.fn, anchor_pt, stage.anchor,
                                      parts, placement, unwrap=unwrap,
                                      sides=sides, combine=combine,
                                      trace=trace))
        twin.serves += 1
        self._record_twin_cost(twin, fresh, tags,
                               time.perf_counter() - t0)
        with self._lock:
            self.stats.shard_waves += placement.n_waves
            self.stats.partitions_scanned += len(parts)
            self.stats.partitions_pruned += \
                anchor_pt.n_partitions - len(parts)
        return out, max(placement.n_morsels, 1)

    def _run_exchange(self, compiled: CompiledPrediction, stage: Any,
                      pts: Dict[str, Any], combine: Optional[Any] = None,
                      unwrap: Optional[Any] = None,
                      trace: Any = NULL_TRACE
                      ) -> Tuple[bool, Any, int]:
        """Run one local program via the hash-repartition shuffle
        (``serve/exchange.py`` + ``ShardedExecutor.execute_exchange``).

        Both sides' surviving rows are gathered on the device (in
        partition order — the original row order the scatter-back
        restores), their join keys hashed on the host into a
        data-deterministic bucket split, and the per-bucket joins run as
        device waves.  Returns ``(ok, output, #buckets)``; ``ok=False`` means the cost model gated the shuffle
        off (bytes moved + dispatch exceed the whole-table win) and the
        caller should fall back."""
        from ..core.cost_model import exchange_beneficial
        from .exchange import choose_bucket_count, plan_exchange
        cfg = self.execution_config
        executor = self._shard_executor()
        exch = stage.exchange

        def gather(table_name: str):
            """The surviving rows of one side, in partition order, on the
            tables' device."""
            pt = pts[table_name]
            scan = next(n for n in stage.local_plan.nodes.values()
                        if n.op == "scan"
                        and n.attrs["table"] == table_name)
            surviving = scan.attrs.get("partitions")
            if surviving is None \
                    or any(i >= pt.n_partitions for i in surviving):
                surviving = tuple(range(pt.n_partitions))
            table = pt.table
            if len(surviving) != pt.n_partitions:
                parts = [pt.partitions[i] for i in surviving]
                table = _concat_outputs(
                    [table.row_slice(p.start, p.stop) for p in parts]) \
                    if parts else table.row_slice(0, 0)
            return table, len(surviving), pt.n_partitions

        with trace.span("exchange_build", on=exch.on) as sp:
            a_table, a_used, a_total = gather(exch.left)
            s_table, s_used, s_total = gather(exch.right)
            n_buckets = choose_bucket_count(a_table.capacity,
                                            executor.n_devices,
                                            cfg.shard_morsel_rows)
            if cfg.shard_exchange_cost_gate and not exchange_beneficial(
                    a_table.capacity, s_table.capacity, executor.n_devices,
                    n_buckets):
                with self._lock:
                    self.stats.exchange_fallbacks += 1
                trace.event("exchange_fallback", rows=a_table.capacity)
                return False, None, 0
            # the plan is made on the host: only the key columns come
            # across; the rows stay on the device
            placement = plan_exchange(a_table.column(exch.on),
                                      s_table.column(exch.on),
                                      n_buckets, cfg.shard_min_bucket_rows)
            if sp is not None:
                sp.attrs.update(placement.describe())
        twin, fresh, tags = self._twin_executable(
            compiled,
            sharded_signature(stage.local_sig, placement.anchor_rows,
                              executor.mesh_shape,
                              ((exch.right, placement.side_rows),),
                              exchange=(placement.n_buckets,
                                        placement.anchor_rows)),
            placement.anchor_rows, "shard_hits", "shard_compiles",
            raw_fn=stage.local_raw_fn)
        t0 = time.perf_counter()
        out = _ready(executor.execute_exchange(
            twin.fn, a_table, exch.left, s_table, exch.right, placement,
            unwrap=unwrap, combine=combine, trace=trace))
        twin.serves += 1
        self._record_twin_cost(twin, fresh, tags,
                               time.perf_counter() - t0)

        def row_bytes(table: Table) -> int:
            return 1 + sum(v.element_size() * math.prod(v.shape[1:])
                           for v in table.columns.values())  # + validity

        moved = placement.bytes_moved(row_bytes(a_table),
                                      row_bytes(s_table))
        with self._lock:
            self.stats.exchange_executions += 1
            self.stats.exchange_bytes_moved += moved
            self.stats.shard_waves += placement.n_waves(executor.n_devices)
            self.stats.partitions_scanned += a_used + s_used
            self.stats.partitions_pruned += \
                (a_total - a_used) + (s_total - s_used)
        return True, out, max(len(placement.active_buckets), 1)

    def shard_info(self) -> Dict[str, Any]:
        """Partition-parallel ledger: device geometry plus how much work the
        zone maps skipped and how often the distributed (join/aggregation)
        tiers ran."""
        executor = self._shard_exec
        with self._lock:
            s = self.stats
            total = s.partitions_scanned + s.partitions_pruned
            return {
                "enabled": self.execution_config.sharded,
                "devices": executor.n_devices
                if executor is not None else None,
                "mesh_shape": executor.mesh_shape
                if executor is not None else None,
                "sharded_executions": s.sharded_executions,
                "shard_compiles": s.shard_compiles,
                "shard_hits": s.shard_hits,
                "shard_waves": s.shard_waves,
                "partitions_scanned": s.partitions_scanned,
                "partitions_pruned": s.partitions_pruned,
                "prune_rate": s.partitions_pruned / total if total else 0.0,
                "join_executions": s.shard_join_executions,
                "agg_combines": s.shard_agg_combines,
                "partial_aggs": s.shard_partial_aggs,
                "exchange_executions": s.exchange_executions,
                "exchange_fallbacks": s.exchange_fallbacks,
                "exchange_bytes_moved": s.exchange_bytes_moved,
            }

    def _execute_spliced(self, compiled: CompiledPrediction,
                         tabs: Dict[str, Table],
                         ctx: Optional[RequestContext] = None,
                         trace: Any = NULL_TRACE) -> Any:
        """Serve a spliced plan, recovering its slot value by the cheapest
        sound tier: exact cached value -> pre-append snapshot within the
        freshness SLA -> prefix + delta-rows execution (streaming ingest)
        -> whole-subtree rematerialization."""
        ref = compiled.splice
        rkey = self._result_key(ref)
        value = self._result_cache.get(rkey) \
            if self._result_cache is not None else None
        hit = value is not None
        with self._lock:
            self.stats.spliced_executions += 1
            if hit:
                self.stats.result_hits += 1
            else:
                self.stats.result_misses += 1
        from_prefix = False
        if value is None:       # version moved or evicted: prefix tiers
            value = self._serve_from_prefix(compiled, ref, rkey, tabs,
                                            ctx=ctx, trace=trace)
            from_prefix = value is not None
        if value is None:       # no lineage to exploit: rebuild, repopulate
            with trace.span("rematerialize", sig=ref.sig[:16]):
                value = self._materialize(ref)
        with trace.span("result_cache_splice", hit=hit,
                        subtree=ref.describe()):
            # Prefix-tier serves run the residual through the unwrapped
            # closure: under streaming ingest the slot's row count grows
            # with every append, and counting a trace of the (tiny,
            # cosmetic) residual per append would put a specialization
            # back on the very path the delta tier keeps compile-free.
            if from_prefix and compiled.raw_fn is not None:
                return compiled.raw_fn({**tabs, ref.slot: value},
                                       trace=trace)
            return compiled.fn({**tabs, ref.slot: value}, trace=trace)

    def _serve_from_prefix(self, compiled: CompiledPrediction,
                           ref: SubplanRef, rkey: Tuple,
                           tabs: Dict[str, Table],
                           ctx: Optional[RequestContext] = None,
                           trace: Any = NULL_TRACE) -> Optional[Any]:
        """Exact result-key miss under streaming ingest: recover the slot
        value from a cached *prefix* of the same lineage — either serving
        the pre-append snapshot outright (freshness SLA: the request said
        an answer this many seconds old is acceptable) or executing the
        subtree over only the appended delta rows and concatenating
        (incremental maintenance; bitwise-equal by row-locality).  Returns
        ``None`` when no tier applies — the caller rematerializes, which
        is always sound."""
        found = self._prefix_entry(ref)
        if found is None:
            return None
        old_key, entry, prefix_rows = found
        (t,) = ref.scan_tables
        # Tier 1: freshness SLA.  The prefix value *is* the answer over a
        # snapshot exactly one append old; when the caller's staleness
        # budget covers that append's age, serve it without touching the
        # delta — the residual's own scan of the table (if any) is sliced
        # back to the same snapshot so the whole answer is consistent.
        budget = self._staleness_budget(ctx)
        if budget is not None:
            appended_at = self._append_times.get(t)
            age = None if appended_at is None \
                else max(0.0, self.clock.monotonic() - appended_at)
            if age is not None and age <= budget:
                if t in tabs:
                    tabs[t] = _slice_table(tabs[t], 0, prefix_rows)
                # recency bump so the entry survives while the SLA holds
                self._result_cache.get(old_key, count=False)
                with self._lock:
                    self.stats.stale_serves += 1
                trace.event("stale_serve", table=t, age_s=age,
                            budget_s=budget, rows=prefix_rows)
                return entry.value
        # Tier 2: delta execution — row-local subtrees only (every output
        # row depends on exactly its input row, so prefix and delta
        # outputs concatenate to the bitwise whole-table value).
        if all(n.op in _ROW_LOCAL_OPS
               for n in ref.subtree_plan.nodes.values()):
            value = self._delta_value(compiled, ref, rkey, entry, old_key,
                                      prefix_rows, t, trace=trace)
            if value is not None:
                return value
        with self._lock:
            self.stats.delta_fallbacks += 1
        trace.event("delta_fallback", table=t)
        return None

    def _delta_value(self, compiled: CompiledPrediction, ref: SubplanRef,
                     rkey: Tuple, entry: Any, old_key: Tuple,
                     prefix_rows: int, t: str,
                     trace: Any = NULL_TRACE) -> Optional[Any]:
        """Run the subtree over only the appended rows and splice the
        cached prefix in front.  The delta execution reuses the admission
        tier's shape-bucket machinery (pad the delta to a power-of-two
        bucket, one cached twin executable per bucket), so steady-state
        appends of similar size never trace or compile anything new."""
        table = self.catalog.get_table(t)
        d = table.capacity - prefix_rows
        if d <= 0:
            return None
        cfg = self.batcher.config
        bucket = pow2_bucket(d, cfg.min_bucket_rows, cfg.max_bucket_rows)
        raw_fn = self._subtree_raw_fn(ref)
        twin, fresh, tags = self._twin_executable(
            compiled, bucketed_signature(f"delta::{ref.sig}", bucket),
            bucket, "bucket_hits", "bucket_compiles", raw_fn=raw_fn)
        t0 = time.perf_counter()
        with trace.span("delta_execute", table=t, rows=d, bucket=bucket,
                        fresh_bucket=fresh):
            delta = _slice_table(table, prefix_rows, bucket)
            dval = twin.fn({t: delta})
            value = _ready(_concat_outputs([entry.value,
                                            _trim_rows(dval, d)]))
        elapsed = time.perf_counter() - t0
        twin.serves += 1
        self._record_twin_cost(twin, fresh, tags, elapsed)
        if self._result_cache is not None:
            # the spliced successor replaces the prefix entry (same
            # lineage, strictly more rows): store first, then retire the
            # prefix so the bytes budget never double-charges the pair
            evicted = self._result_cache.put(
                rkey, value, cost_s=entry.cost_s + elapsed,
                tags=entry.tags, tenant=entry.tenant)
            popped = self._result_cache.pop(old_key)
            with self._lock:
                self.stats.result_puts += 1
                self.stats.result_evictions += len(evicted)
                if popped is not None:
                    self.stats.prefix_supersedes += 1
        with self._lock:
            self.stats.delta_serves += 1
            self.stats.delta_rows_scanned += d
        return value

    def _execute_chunked(self, compiled: CompiledPrediction,
                         tabs: Dict[str, Table],
                         store_capture: bool = True,
                         tenant: Optional[str] = None,
                         trace: Any = NULL_TRACE) -> Any:
        """Morsel execution: every chunk (tail included, via padding) has the
        same shape, so the executable sees one chunk signature total."""
        name = compiled.chunk_table
        table = tabs[name]
        n = table.capacity
        trace.event("chunked", rows=n, chunk_rows=self.chunk_rows)
        pieces, captured = [], []
        resident = self._capture_resident(compiled, trace)
        t0 = time.perf_counter()
        for start in range(0, n, self.chunk_rows):
            chunk = _slice_table(table, start, self.chunk_rows)
            raw = compiled.fn({**tabs, name: chunk}, trace=trace)
            if compiled.capture is not None:
                pieces.append(raw[0])
                captured.append(raw[1])
            else:
                pieces.append(raw)
            with self._lock:
                self.stats.chunks_executed += 1
        if compiled.capture is not None and captured:
            # chunk_table plans are row-local end to end, so chunked capture
            # concatenates to exactly the whole-table subtree value
            cap = _ready(_trim_rows(_concat_outputs(captured), n)) \
                if store_capture else None
            self._store_capture(compiled, cap, time.perf_counter() - t0,
                                store_capture, resident, tenant, trace)
        return _trim_rows(_concat_outputs(pieces), n)

    def run(self, query: Union[str, Plan],
            tables: Optional[Dict[str, Table]] = None,
            params: Any = None,
            ctx: Optional[RequestContext] = None,
            tenant: Optional[str] = None, priority: int = 0,
            deadline_s: Optional[float] = None,
            max_staleness_s: Optional[float] = None) -> Any:
        """Synchronous serve.  Goes through the admission queue, so requests
        issued concurrently from other threads coalesce with this one.
        Under a background admission loop the request is served within the
        latency budget; otherwise this flushes immediately.
        ``max_staleness_s`` is the request's freshness SLA under streaming
        ingest (see :class:`~repro.serve.context.RequestContext`)."""
        ticket = self.submit(query, tables, params=params, ctx=ctx,
                             tenant=tenant, priority=priority,
                             deadline_s=deadline_s,
                             max_staleness_s=max_staleness_s)
        if self._loop is None:
            self.flush()
        return ticket.result()

    def sql(self, query: str, params: Any = None,
            tables: Optional[Dict[str, Table]] = None,
            ctx: Optional[RequestContext] = None,
            tenant: Optional[str] = None, priority: int = 0,
            deadline_s: Optional[float] = None,
            max_staleness_s: Optional[float] = None) -> Any:
        """Front door: serve a SQL text synchronously.

        ``params`` binds the query's placeholders — positional (a sequence,
        for ``?``) or named (a mapping, for ``:name``).  Differing literal
        *values* share one plan signature, one compiled executable, and one
        parse-cache entry; only the bound values travel with the request,
        so a hot parameterized query never recompiles (satellite guarantee:
        zero warm compiles across distinct literals).  The exception is
        *structural* positions (``LIMIT :n``): those bind at plan-build
        time, so each distinct value is its own signature/executable —
        see :func:`repro.core.codegen.bind_structural_params`.
        ``tenant``/``ctx``
        route the request through that tenant's admission queue, cache
        quota and stats ledger; both default to the single-tenant path."""
        return self.run(query, tables, params=params, ctx=ctx,
                        tenant=tenant, priority=priority,
                        deadline_s=deadline_s,
                        max_staleness_s=max_staleness_s)

    def predict(self, query: Union[str, Plan],
                tables: Optional[Dict[str, Table]] = None, **kw) -> Any:
        """Synchronous single-request serve (alias of :meth:`run`; the name
        :class:`~repro.serve.context.Session` uses)."""
        return self.run(query, tables, **kw)

    # -- micro-batch admission -----------------------------------------------
    def submit(self, query: Union[str, Plan],
               tables: Optional[Dict[str, Table]] = None,
               params: Any = None,
               ctx: Optional[RequestContext] = None,
               tenant: Optional[str] = None, priority: int = 0,
               deadline_s: Optional[float] = None,
               max_staleness_s: Optional[float] = None
               ) -> PredictionTicket:
        """Admit one request.  Blocks under backpressure (bounded queue);
        raises :class:`~repro.serve.admission.AdmissionQueueFull` when the
        queue stays full past the offer timeout (or immediately with
        ``block_on_full=False``).  A request whose cache key cannot be
        computed (e.g. unknown table) or whose parameter bindings do not
        match the plan's placeholders fails its ticket instead of
        poisoning the batch it would have joined."""
        ctx = self._resolve_ctx(ctx, tenant, priority, deadline_s,
                                max_staleness_s)
        ticket = PredictionTicket()
        trace = self._new_trace(
            query if isinstance(query, str) else "request", ctx)
        if trace.enabled:
            ticket._trace = trace
            if ctx is not None:
                # Per-request copy: a Session's ctx is shared across
                # concurrent calls, so the trace is stamped on a private
                # clone (trace is compare=False — grouping unaffected).
                ctx = dataclasses.replace(ctx)
                object.__setattr__(ctx, "trace", trace)
        try:
            with trace.span("parse"):
                plan = self._to_plan(query)
                bound = None
                if params is not None or plan_params(plan):
                    bound = resolve_params(plan, params) or None
                    # Structural params (LIMIT :n) bind into a plan copy
                    # *before* the cache key: each distinct value is its own
                    # plan signature, so cached executables stay distinct
                    # per value.
                    plan, bound = bind_structural_params(plan, bound)
                    bound = bound or None
                key, _ = self._cache_key(plan, tables)
        except Exception as err:
            trace.event("error", stage="parse", error=repr(err))
            self._finish_trace(trace)
            ticket._fail(err)
            return ticket
        # Deadline-based shedding: once the queue-wait EWMA and this key's
        # execution EWMA are both calibrated, a request whose deadline is
        # below their sum is doomed — admitting it would only occupy queue
        # and batch space to miss anyway.  Cold signatures never shed (no
        # estimate), and the estimate rides the injected clock, so the
        # fake-clock tests pin the behavior deterministically.
        if ctx is not None and ctx.deadline_s is not None:
            est = self._deadline_estimate(key, ctx.tenant)
            if est is not None and est > ctx.deadline_s:
                err = DeadlineUnmeetable(
                    f"deadline {ctx.deadline_s:.4f}s unmeetable: estimated "
                    f"queue wait + execution is {est:.4f}s")
                with self._lock:
                    self.stats.deadline_rejections += 1
                    ts = self._tenant_stat(ctx.tenant)
                    if ts is not None:
                        ts.deadline_rejections += 1
                trace.event("deadline_shed", estimate=est,
                            deadline=ctx.deadline_s)
                self._finish_trace(trace)
                ticket._fail(err)
                raise err
        # Parameterized requests group by (cache key, binding fingerprint):
        # different bindings share the executable but never one execution
        # (their outputs differ); identical bindings still coalesce.  The
        # unparameterized path offers the bare key — byte-for-byte the
        # pre-parameter batch identity.
        batch_key: Any = key
        if bound is not None:
            fp = tuple(sorted(
                (k, str(to_numpy(v).dtype), to_numpy(v).tobytes())
                for k, v in bound.items()))
            batch_key = (key, "__params__", fp)
        try:
            # key[2] is the overridden-tables tuple: only override-table
            # requests stack (batch size matters); identical-catalog
            # groups share one execution and must never be split
            self.batcher.offer(batch_key,
                               _Pending(plan, tables, ticket,
                                        params=bound, ctx=ctx, trace=trace,
                                        thread=threading.get_ident()),
                               chunk=bool(key[2]), ctx=ctx)
        except AdmissionQueueFull:
            with self._lock:
                self.stats.queue_rejections += 1
            trace.event("queue_rejected")
            self._finish_trace(trace)
            raise
        with self._lock:
            self.stats.submitted += 1
            ts = self._tenant_stat(ctx.tenant if ctx else None)
            if ts is not None:
                ts.submitted += 1
        return ticket

    def flush(self) -> int:
        """Drain the admission queue regardless of deadlines, coalescing
        requests that share a cache key into single batched executions.
        Returns #requests served."""
        return self.admission_tick(force=True)

    def admission_tick(self, force: bool = False) -> int:
        """Serve every group that is due at the current (injectable) clock
        reading — the deterministic seam the background loop and the fake-
        clock tests share.  ``force`` serves everything (explicit flush)."""
        served = 0
        groups = self.batcher.drain() if force \
            else self.batcher.pop_ready(self.clock.monotonic())
        for group in groups:
            served += self._serve_ready(group)
        return served

    def _serve_ready(self, group: ReadyGroup) -> int:
        """Account for one released group (flush reason + queue latency),
        then serve it.  Called by the loop thread, ``flush()``, and
        ``admission_tick``; ``_flush_lock`` serializes the execution."""
        now = self.clock.monotonic()
        tenant = group.ctx.tenant if group.ctx is not None else None
        lats: List[float] = []
        with self._lock:
            if group.reason == "deadline":
                self.stats.deadline_flushes += 1
            elif group.reason == "full":
                self.stats.size_flushes += 1
            else:
                self.stats.drain_flushes += 1
            ts = self._tenant_stat(tenant)
            for t in group.admitted_at:
                lat = max(0.0, now - t)
                lats.append(lat)
                self._queue_latencies.append(lat)
                if ts is not None:
                    ts.latencies.append(lat)
                    # per-tenant shedding calibration: the tenant's own
                    # queue-wait EWMA (preferred by _deadline_estimate)
                    if ts.queue_wait_ewma is None:
                        ts.queue_wait_ewma = lat
                    else:
                        ts.queue_wait_ewma += \
                            0.2 * (lat - ts.queue_wait_ewma)
                # deadline-shedding calibration (injected-clock seconds)
                if self._queue_wait_ewma is None:
                    self._queue_wait_ewma = lat
                else:
                    self._queue_wait_ewma += \
                        0.2 * (lat - self._queue_wait_ewma)
        for p, t, lat in zip(group.items, group.admitted_at, lats):
            p.trace.add_span("queue_wait", t, t + lat,
                             reason=group.reason)
        if self.telemetry:             # outside self._lock by construction
            for lat in lats:
                self.metrics.observe(
                    "repro_queue_wait_seconds", lat,
                    labels={"tenant": tenant} if tenant else None)
        with self._flush_lock:
            if self.telemetry:
                # released at ``now`` (where queue_wait ended), waited for
                # the execution lane until here
                got = self.clock.monotonic()
                me = threading.get_ident()
                for p in group.items:
                    p.trace.add_span("lane_wait", now, got,
                                     own_flush=p.thread == me)
            served = self._serve_group(group.key, group.items)
        if tenant is not None and served:
            with self._lock:
                self._tenant_stat(tenant).served += served
        return served

    def _fail_group(self, group: ReadyGroup, err: BaseException) -> None:
        """Loop escape hatch: an error that got past ``_serve_group``'s own
        handlers must still fail the group's tickets — a caller blocked in
        ``result()`` with no timeout would otherwise hang forever."""
        for p in group.items:
            if not p.ticket.done:
                p.trace.event("error", stage="serve", error=repr(err))
                p.ticket._fail(err)
            self._finish_trace(p.trace)

    def _serve_group(self, key: Tuple, group: List[_Pending]) -> int:
        head = group[0]
        # One group = one binding (the fingerprint is part of the batch
        # key), so the head's resolved params and tenant speak for all —
        # and the head's trace records the group-level compile/execute
        # phases (non-head members mark themselves coalesced).
        params = head.params
        tenant = head.ctx.tenant if head.ctx is not None else None
        trace = head.trace
        if params is not None:
            key = key[0]               # strip the binding fingerprint

        def seal(err: Optional[BaseException]) -> None:
            for p in group:
                if err is not None and not p.ticket.done:
                    p.trace.event("error", stage="serve", error=repr(err))
                    p.ticket._fail(err)
                self._finish_trace(p.trace)

        try:
            # key[0] is the plan signature (first component of _cache_key)
            compiled = self.compile(head.plan, head.tables,
                                    _key=(key, key[0]), ctx=head.ctx,
                                    trace=trace)
        except Exception as err:
            seal(err)
            return 0
        t0 = self.clock.monotonic()
        try:
            if all(not p.tables for p in group):
                # identical inputs (catalog tables): one execution at the
                # catalog's natural (fixed) shape, fanned out to every ticket
                with trace.span("execute", coalesced=len(group) - 1):
                    out = self._execute(compiled, None, params=params,
                                        tenant=tenant, ctx=head.ctx,
                                        trace=trace)
                for p in group:
                    if p is not head:
                        p.trace.event("coalesced", group=len(group))
                    p.ticket._resolve(out)
                with self._lock:
                    self.stats.coalesced_requests += len(group) - 1
                    ts = self._tenant_stat(tenant)
                    if ts is not None:
                        ts.coalesced += len(group) - 1
            elif compiled.chunk_table is not None:
                # caller-supplied row counts vary request to request, so
                # even a group of one goes through the shape-bucketed
                # stacked path — arrival patterns must not multiply compiles
                self._serve_stacked(compiled, group, params=params,
                                    tenant=tenant)
            else:
                for p in group:
                    with p.trace.span("execute"):
                        p.ticket._resolve(self._execute(
                            compiled, p.tables, params=params,
                            tenant=tenant, ctx=p.ctx, trace=p.trace))
        except Exception as err:
            seal(err)
            return 0
        # execution-time EWMA per cache key (injected clock; excludes the
        # one-off compile) — the other half of the deadline-shed estimate
        dt = max(0.0, self.clock.monotonic() - t0)
        with self._lock:
            if len(self._exec_ewma) >= 1024:
                self._exec_ewma.clear()     # key churn: cheap full reset
            prev = self._exec_ewma.get(key)
            self._exec_ewma[key] = dt if prev is None \
                else prev + 0.2 * (dt - prev)
        if self.telemetry:             # outside self._lock by construction
            self.metrics.observe(
                "repro_exec_seconds", dt,
                labels={"tenant": tenant} if tenant else None)
        seal(None)
        return len(group)

    def _bucket_rows(self, n: int) -> int:
        cfg = self.batcher.config
        return pow2_bucket(n, cfg.min_bucket_rows, cfg.max_bucket_rows)

    def _bucket_executable(self, compiled: CompiledPrediction, bucket: int
                           ) -> Tuple[CompiledPrediction, bool, Tuple]:
        """Shape-specialized twin of ``compiled`` for stacked micro-batches
        (see :meth:`_twin_executable`)."""
        return self._twin_executable(
            compiled, bucketed_signature(compiled.signature, bucket),
            bucket, "bucket_hits", "bucket_compiles")

    def _sharded_executable(self, compiled: CompiledPrediction, bucket: int
                            ) -> Tuple[CompiledPrediction, bool, Tuple]:
        """Shape-specialized twin for partition-parallel execution: one
        executable per (signature, morsel bucket, device count) — every
        device and every wave runs the same input signature, so the
        compile count is independent of partition and device counts."""
        return self._twin_executable(
            compiled, sharded_signature(compiled.signature, bucket,
                                        self._shard_exec.mesh_shape),
            bucket, "shard_hits", "shard_compiles")

    def _twin_executable(self, compiled: CompiledPrediction,
                         derived_sig: str, bucket: int, hit_stat: str,
                         compile_stat: str, raw_fn: Any = None
                         ) -> Tuple[CompiledPrediction, bool, Tuple]:
        """Shape-specialized twin of ``compiled``: same optimized plan and
        codegen closure, its own trace-accounting wrapper, cached under
        the (cache key, derived signature) pair so each derived shape
        compiles at most once while it stays resident.  ``raw_fn``
        overrides the closure being wrapped — the distributed tier's twin
        wraps the *local* (per-morsel) program and the delta tier's the
        captured *subtree*, not the whole plan.  Returns
        ``(executable, fresh, tags)`` — ``fresh`` lets the caller time the
        first (tracing) execution and re-put the observed cost (with the
        same ``tags``, so a twin whose zero-cost initial insert
        self-evicted is re-created tagged and stays reachable by
        invalidation), giving eviction an honest replacement price instead
        of the near-zero closure-wrapping time."""
        bkey = (compiled.key, derived_sig)
        hit = self._exec_cache.get(bkey, count=False)
        if hit is not None:
            with self._lock:
                setattr(self.stats, hit_stat,
                        getattr(self.stats, hit_stat) + 1)
            return hit, False, ()
        with self._lock:
            setattr(self.stats, compile_stat,
                    getattr(self.stats, compile_stat) + 1)
        derived = dataclasses.replace(
            compiled, key=bkey,
            fn=self._jit(raw_fn if raw_fn is not None else compiled.raw_fn),
            bucket_rows=bucket, serves=0)
        base = self._exec_cache.entry(compiled.key)
        tags = base.tags if base is not None else (
            tuple(("model", m) for m in compiled.model_names)
            + tuple(("table", t) for t in compiled.scan_tables))
        # nbytes=0: the twin shares the base entry's plan artifacts, and
        # it holds nothing of its own beyond a small wrapper
        evicted = self._exec_cache.put(bkey, derived, cost_s=0.0,
                                       nbytes=0, tags=tags)
        with self._lock:
            self.stats.evictions += len(evicted)
        entry = self._exec_cache.entry(bkey)
        return (entry.value if entry is not None else derived), True, tags

    def _record_twin_cost(self, twin: CompiledPrediction, fresh: bool,
                          tags: Tuple, elapsed_s: float) -> None:
        """After a *fresh* twin's first (tracing) execution, re-put it with
        the observed cost so eviction sees an honest replacement price
        instead of the near-zero closure-wrapping time; tags are repeated
        so that, if the zero-cost insert self-evicted under a full cache,
        the entry re-created here stays reachable by model/table
        invalidation.  Shared by the stacked (bucket), sharded and delta
        tiers —
        the re-put contract must not diverge between them."""
        if not fresh:
            return
        evicted = self._exec_cache.put(twin.key, twin, cost_s=elapsed_s,
                                       nbytes=0, tags=tags)
        with self._lock:
            self.stats.evictions += len(evicted)

    def _execute_direct(self, compiled: CompiledPrediction,
                        tabs: Dict[str, Table],
                        trace: Any = NULL_TRACE) -> Any:
        """Execute a shape-bucket executable on already-padded inputs: no
        chunk split (the bucket *is* the static shape) and no capture store
        (a padded stack is not the catalog data the result-cache key would
        claim)."""
        compiled.serves += 1
        with self._lock:
            self.stats.batch_executions += 1
        raw = compiled.fn(tabs, trace=trace)
        if compiled.capture is not None:
            raw = raw[0]
        return _ready(raw)

    def _serve_stacked(self, compiled: CompiledPrediction,
                       group: List[_Pending],
                       params: Optional[Dict[str, Any]] = None,
                       tenant: Optional[str] = None):
        """Row-local plans: stack every request's input rows into one padded
        execution, then split the output back by request offsets.  Padding
        goes to a power-of-two row bucket with its own cached executable
        (bit-exact after unpadding: pad rows carry ``valid=False`` and
        row-local ops never mix rows), so however batch sizes vary, at most
        O(log max_batch) input signatures ever reach an executable."""
        name = compiled.chunk_table
        trace = group[0].trace         # head records the batch-level spans
        inputs = [self._input_tables(compiled, p.tables)[name]
                  for p in group]
        sizes = [t.capacity for t in inputs]
        total = sum(sizes)
        if self.chunk_rows and total > self.chunk_rows:
            # morsel execution already fixes the shape at chunk_rows (one
            # chunk-shaped executable total): pad to a chunk multiple
            with trace.span("bucket_pad", rows=total,
                            bucket=_round_up(total, self.chunk_rows)):
                stacked = _stack_pad(inputs,
                                     _round_up(total, self.chunk_rows))
            with trace.span("execute", stacked=len(group)):
                out = self._execute(compiled, {name: stacked},
                                    store_capture=False, params=params,
                                    tenant=tenant, trace=trace)
        else:
            bucket = self._bucket_rows(total)
            bcompiled, fresh, btags = self._bucket_executable(compiled,
                                                              bucket)
            with trace.span("bucket_pad", rows=total, bucket=bucket,
                            fresh_bucket=fresh):
                stacked = _stack_pad(inputs, bucket)
            tabs: Dict[str, Any] = {name: stacked}
            if params:
                tabs["__params__"] = params
            t0 = time.perf_counter()
            with trace.span("execute", stacked=len(group), bucket=bucket):
                out = self._execute_direct(bcompiled, tabs, trace=trace)
            self._record_twin_cost(bcompiled, fresh, btags,
                                   time.perf_counter() - t0)
        # no trim first: the split only reads rows up to sum(sizes), so
        # the padded tail is simply never referenced
        for p, piece in zip(group, _split_output(out, sizes)):
            if p is not group[0]:
                p.trace.event("coalesced", group=len(group))
            p.ticket._resolve(piece)
        with self._lock:
            self.stats.coalesced_requests += len(group) - 1
            ts = self._tenant_stat(tenant)
            if ts is not None:
                ts.coalesced += len(group) - 1
