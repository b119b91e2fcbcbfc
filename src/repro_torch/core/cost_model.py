"""Cost model + cost-based operator-implementation choice (paper §4.3).

The paper ships a heuristic rule order and names the destination: "a
cost-based Cascades-style optimizer ... each operator associated with a
cost; several plan alternatives will be considered and the best picked".
This module is that first cut:

- **cardinality estimation**: row counts propagate through the plan;
  selectivities come from registered column stats (equality: 1/n_distinct;
  range: uniform fraction of [min, max]; unknown: 1/3);
- **operator costs**: per-row costs for relational ops and for the three
  implementations of a tree model (gather traversal, inlined CASE, GEMM),
  with a backend-dependent flop discount (on an accelerator dense flops are
  cheap relative to gathers — the Fig 2d crossover);
- **choice**: ``choose_tree_impl`` evaluates the alternatives per predict
  chain and the cross-optimizer applies the argmin (CrossOptimizer
  ``cost_based=True``).

The backend is the device the catalog's tables live on: ``"cuda"`` or
``"cpu"`` (:func:`backend_of`).  The hand-written kernel strategy
(``"cuda"``) costs ``inf`` anywhere else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..relational.expr import extract_constraints
from .ir import Plan

__all__ = ["CostParams", "backend_of", "estimate_rows", "estimate_slots",
           "strategy_rows", "tree_impl_costs",
           "choose_tree_impl", "TreeStrategyCalibration",
           "measure_tree_calibration", "calibrated_tree_costs",
           "tree_strategy_costs", "choose_tree_strategy",
           "exchange_cost", "whole_join_cost", "exchange_beneficial"]


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Per-element abstract costs (the *ratios* drive the choices).

    The backend asymmetry is the whole story: CPUs chase pointers cheaply
    and pay full price per flop; an accelerator makes dense flops far
    cheaper but data-dependent gathers dearer — which is why NN translation
    can win on accelerators (paper Fig 2d).  These ratios are abstract and
    unmeasured; the strategy choice below runs on measured constants."""
    c_gather: float = 4.0        # random-access load (tree traversal step)
    c_cmp: float = 1.0           # scalar compare / select (CASE step)
    c_flop_cpu: float = 1.0      # dense multiply-add, CPU
    c_flop_accel: float = 0.02   # dense multiply-add on an accelerator
    c_row_io: float = 1.0        # touch one column value

    @classmethod
    def for_backend(cls, backend: str = "cpu") -> "CostParams":
        if backend == "cuda":
            return dataclasses.replace(cls(), c_gather=64.0)
        return dataclasses.replace(cls(), c_flop_accel=cls.c_flop_cpu)


def backend_of(catalog) -> str:
    """``"cuda"`` when the catalog's tables live on a CUDA device, else
    ``"cpu"`` (a catalog without a device is a host catalog)."""
    device = getattr(catalog, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        return "cuda"
    return "cpu"


_DEFAULT_SELECTIVITY = 1.0 / 3.0


# -- hash-repartition exchange gate ------------------------------------------
#
# The shuffle moves every participating row host->device once (gather +
# device_put) and pays a fixed dispatch/padding overhead per hash bucket;
# in exchange the sort-merge join compute divides across the mesh.  On
# small inputs the per-bucket overhead dominates — whole-table execution
# on one device is simply cheaper — so the serving layer asks
# ``exchange_beneficial`` with the *actual* (post-pruning) row counts
# before committing to the shuffle and falls back otherwise.

# Abstract cost of launching one padded bucket (device_put latency, thread
# dispatch, padding waste).  Calibrated coarsely: at 8 devices the
# crossover lands at a few thousand rows, far below any table worth
# sharding and above the toy sizes where whole-table wins outright.
_EXCHANGE_DISPATCH_COST = 4096.0


def _log2_rows(n: float) -> float:
    return float(np.log2(max(n, 2.0)))


def whole_join_cost(anchor_rows: float, side_rows: float,
                    params: Optional[CostParams] = None) -> float:
    """Single-device sort-merge equi-join: both sides sorted/probed
    (``c_cmp`` per compare level) plus a gather per output row."""
    p = params or CostParams()
    total = float(anchor_rows) + float(side_rows)
    return total * (p.c_cmp * _log2_rows(side_rows) + p.c_gather)


def exchange_cost(anchor_rows: float, side_rows: float, n_devices: int,
                  n_buckets: int,
                  params: Optional[CostParams] = None) -> float:
    """Hash-repartition shuffle + per-bucket joins: every row is hashed,
    gathered host-side and uploaded once (bytes moved — ``c_row_io``
    each way), the join compute divides across ``n_devices``, and each
    bucket pays a fixed dispatch overhead."""
    p = params or CostParams()
    total = float(anchor_rows) + float(side_rows)
    moved = total * p.c_row_io * 2.0
    per_device = total / max(int(n_devices), 1)
    compute = per_device * (p.c_cmp * _log2_rows(side_rows) + p.c_gather)
    dispatch = max(int(n_buckets), 1) * _EXCHANGE_DISPATCH_COST
    return moved + compute + dispatch


def exchange_beneficial(anchor_rows: float, side_rows: float,
                        n_devices: int, n_buckets: int,
                        params: Optional[CostParams] = None) -> bool:
    """True when shuffling beats whole-table single-device execution for
    these (post-pruning) row counts."""
    return exchange_cost(anchor_rows, side_rows, n_devices, n_buckets,
                         params) \
        < whole_join_cost(anchor_rows, side_rows, params)


def _predicate_selectivity(pred, catalog, table_hint: Optional[str]) -> float:
    sel = 1.0
    stats = catalog.get_stats(table_hint) if table_hint else {}
    for c in extract_constraints(pred):
        st = stats.get(c.column)
        if st is None:
            sel *= _DEFAULT_SELECTIVITY
        elif c.kind == "==":
            sel *= 1.0 / max(st.n_distinct, 1)
        elif c.kind in ("<", "<=", ">", ">="):
            span = max(st.max - st.min, 1e-9)
            if c.kind in ("<", "<="):
                frac = (float(c.value) - st.min) / span
            else:
                frac = (st.max - float(c.value)) / span
            sel *= float(np.clip(frac, 0.01, 1.0))
        else:
            sel *= _DEFAULT_SELECTIVITY
    return float(np.clip(sel, 1e-4, 1.0))


def _scan_rows(node, catalog) -> float:
    """Rows a scan actually feeds downstream.  Partition-aware: when the
    ``partition_pruning`` rule has recorded a surviving-partition set on
    the scan, only those partitions' rows count — a pruned scan is
    proportionally cheaper, which is exactly what lets the cost-based
    implementation choice pick lighter model forms for highly selective
    partitioned queries."""
    table = node.attrs["table"]
    surviving = node.attrs.get("partitions")
    if surviving is not None:
        pt = getattr(catalog, "get_partitioned", lambda _n: None)(table)
        if pt is not None:
            try:
                return float(sum(pt.partitions[i].n_rows
                                 for i in surviving))
            except IndexError:
                pass          # stale indices (table re-registered): fall back
    try:
        return float(catalog.get_table(table).capacity)
    except Exception:
        return 1e6


def estimate_rows(plan: Plan, catalog) -> Dict[str, float]:
    """Estimated live-row count at each table node's output."""
    rows: Dict[str, float] = {}
    src_table: Dict[str, Optional[str]] = {}
    for nid in plan.topo_order():
        n = plan.node(nid)
        if n.op == "scan":
            rows[nid] = _scan_rows(n, catalog)
            src_table[nid] = n.attrs["table"]
        elif n.op == "filter":
            parent = n.inputs[0]
            sel = _predicate_selectivity(n.attrs["predicate"], catalog,
                                         src_table.get(parent))
            rows[nid] = rows.get(parent, 1e6) * sel
            src_table[nid] = src_table.get(parent)
        elif n.op == "join":
            rows[nid] = rows.get(n.inputs[0], 1e6)   # FK join: |left|
            src_table[nid] = src_table.get(n.inputs[0])
        elif n.op == "limit":
            lim = n.attrs["n"]
            rows[nid] = rows.get(n.inputs[0], 1e6)
            if isinstance(lim, (int, float)):   # may be an unbound Param
                rows[nid] = min(rows[nid], float(lim))
            src_table[nid] = src_table.get(n.inputs[0])
        elif n.op in ("group_agg", "partial_agg"):
            # partial_agg (two-phase local stage) has the same output
            # cardinality as the aggregation it decomposes: one row per
            # group — the `two_phase` attr changes where the combine runs,
            # not how many rows flow downstream
            rows[nid] = float(n.attrs.get("num_groups") or 64)
            src_table[nid] = None
        elif n.inputs:
            rows[nid] = rows.get(n.inputs[0], 1e6)
            src_table[nid] = src_table.get(n.inputs[0])
        else:
            rows[nid] = 1e6
            src_table[nid] = None
    return rows


def estimate_slots(plan: Plan, catalog) -> Dict[str, float]:
    """Physical rows (slots, live or masked) at each table node's output.

    The operators are masked-columnar: a filter clears validity bits and a
    limit keeps the first live rows, but neither drops a slot, so an
    operator above them — a model above all — evaluates every slot of its
    input whatever the live-row estimate says.  Scans carry the table's
    capacity, joins their left side's, aggregations one slot a group,
    unions the sum of their inputs."""
    slots: Dict[str, float] = {}
    for nid in plan.topo_order():
        n = plan.node(nid)
        if n.op == "scan":
            try:
                slots[nid] = float(catalog.get_table(
                    n.attrs["table"]).capacity)
            except Exception:
                slots[nid] = 1e6
        elif n.op in ("group_agg", "partial_agg"):
            slots[nid] = float(n.attrs.get("num_groups") or 64)
        elif n.op == "union":
            slots[nid] = sum(slots.get(i, 1e6) for i in n.inputs)
        elif n.inputs:
            slots[nid] = slots.get(n.inputs[0], 1e6)
        else:
            slots[nid] = 1e6
    return slots


def strategy_rows(plan: Plan, catalog) -> Dict[str, float]:
    """The rows a tree-strategy choice prices at each node: on the card the
    slots a model evaluates (:func:`estimate_slots`, what its per-model
    calibration measures); on the CPU the live-row estimate its stand-in
    calibration was tuned against (:func:`estimate_rows`)."""
    if backend_of(catalog) == "cuda":
        return estimate_slots(plan, catalog)
    return estimate_rows(plan, catalog)


def tree_impl_costs(model, n_rows: float, n_features: int,
                    params: CostParams) -> Dict[str, float]:
    """Per-query cost of the three implementations of a tree model."""
    kind = getattr(model, "kind", None)
    trees = [model.tree] if kind == "decision_tree" else model.trees
    depth = max(t.depth for t in trees)
    nodes = sum(t.n_nodes for t in trees)
    t = len(trees)
    pad = 128

    def up(x):
        return max(pad, ((x + pad - 1) // pad) * pad)

    n_internal = up(max((tt.n_nodes - len(tt.leaf_indices()))
                        for tt in trees))
    n_leaves = up(max(len(tt.leaf_indices()) for tt in trees))
    gemm_flops = t * (n_features * n_internal
                      + n_internal * n_leaves + n_leaves)
    return {
        "traversal": n_rows * t * depth * params.c_gather,
        # only single trees inline to CASE (rule restriction)
        "inline_case": n_rows * nodes * params.c_cmp if t == 1
        else float("inf"),
        "gemm": n_rows * gemm_flops * params.c_flop_accel,
    }


def choose_tree_impl(model, n_rows: float, n_features: int,
                     params: Optional[CostParams] = None) -> str:
    params = params or CostParams.for_backend("cpu")
    costs = tree_impl_costs(model, n_rows, n_features, params)
    return min(costs, key=costs.get)


# --------------------------------------------------------------------------
# Measured tree-strategy crossover (Fig 2d repair).
#
# The abstract CostParams ratios above are fine for rule ordering but were
# wrong about the traversal/GEMM crossover on a CPU.  The strategy choice
# runs on *measured* per-element constants: each strategy is timed at two
# batch sizes, time(n) = call_overhead + n * per_row is solved for each,
# and the result is cached both module-wide and in the ModelStore so every
# optimizer instance sharing the catalog reuses one measurement.
#
# On the CPU the timing runs once per process on a small stand-in forest
# and the per-unit constants are extrapolated to the model at hand.  On the
# card that extrapolation does not hold: traversal's cost per depth step
# and the kernel's cost per flop change with the forest's shape (an 8-tree
# depth-6 stand-in pads I and L to 128, the 64-tree depth-8 Fig 1 forest
# to 256); on an H100 (chip_smoke.py) it ranked traversal 4x under the
# kernel that ran 3x faster.
# So the card times the strategies on the model's own trees, once per
# model (keyed by its content fingerprint): the fitted line then *is* the
# model's cost at any row count, with no extrapolation across shapes.
# --------------------------------------------------------------------------

_CAL_TREES, _CAL_DEPTH, _CAL_FEATURES = 8, 6, 8
# Batch sizes the calibration times, per backend.  On the card, 8192 rows
# still sit in the launch-bound regime (an eager strategy's time is its
# kernel launches, nearly flat in rows), so slopes fitted there rank the
# strategies by launch count, not per-row cost: with the CPU sizes the
# crossover picked the dense GEMM at 1M rows where traversal ran 7x faster
# (H100, chip_smoke.py).  The card calibrates where time grows with rows.
_CAL_SIZES = {"cpu": (512, 8192), "cuda": (1 << 16, 1 << 20)}


@dataclasses.dataclass(frozen=True)
class TreeStrategyCalibration:
    """Measured linear cost models ``time(n) = call + n * per_row_unit``.

    ``trav_step`` is seconds per (row x tree x depth-step); ``gemm_flop`` /
    ``cuda_flop`` are seconds per padded flop of the dense lowering
    (``cuda_flop`` is None off the card — the kernel's plain version on the
    CPU is a correctness path, never a contender)."""

    backend: str
    trav_step: float
    trav_call: float
    gemm_flop: float
    gemm_call: float
    cuda_flop: Optional[float]
    cuda_call: float


def _time_call(fn, *args) -> float:
    """Best of 3 after one warm call.  On the card the host clock brackets
    ``torch.cuda.synchronize()`` on both sides, so it times the work and
    not the enqueue."""
    import time

    def sync():
        if args[0].is_cuda:
            torch.cuda.synchronize()

    fn(*args)                                   # build + warm
    best = float("inf")
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _fit_linear(n_small, t_small, n_big, t_big):
    per_row = max((t_big - t_small) / (n_big - n_small), 1e-12)
    call = max(t_small - n_small * per_row, 0.0)
    return per_row, call


def _dense_flops_per_row(t, n_internal, n_leaves, n_out) -> float:
    # gather-gated dense strategy: I gate ops + I*L path-count MACs + L*O
    # payout MACs per tree per row (the F*I one-hot matmul is gone).
    return float(t * (n_internal + n_internal * n_leaves
                      + n_leaves * n_out))


def _cuda_flops_per_row(t, n_internal, n_leaves, n_out) -> float:
    # the CUDA kernel gates by gather (I compares), takes the I*L path
    # counts on the int8 tensor cores, matches L leaves and adds O payouts
    return float(t * (n_internal + n_internal * n_leaves + n_leaves
                      + n_out))


def measure_tree_calibration(backend: str = "cpu", model=None
                             ) -> TreeStrategyCalibration:
    """Time each strategy at the backend's two batch sizes and fit the
    per-unit constants.  ``model`` (the card only) is the forest to time:
    the constants are then fitted on its own shape, so
    :func:`tree_strategy_costs` reproduces its measured line exactly."""
    from ..kernels.tree_gemm import ops as tg_ops
    from ..ml import ensemble_to_gemm, predict_ensemble_gemm
    from ..ml.hummingbird import ensemble_to_gemm_mxu

    device = torch.device("cuda" if backend == "cuda" else "cpu")
    rng = np.random.default_rng(7)
    if backend == "cuda" and model is not None:
        trees = [model.tree] if model.kind == "decision_tree" \
            else list(model.trees)
        n_feat = int(trees[0].n_features)
        trav = model.scorer(device)
        # the two lowerings nn_translation builds for this forest: the
        # dense strategy's (I, L padded to 8) and the kernel's (to 128)
        dense = ensemble_to_gemm(trees, pad_to=8)
        kernel = ensemble_to_gemm_mxu(trees)
    else:
        from ..ml import RandomForest
        n_feat = _CAL_FEATURES
        xf = rng.normal(size=(1024, n_feat)).astype(np.float32)
        yf = (xf[:, 0] + xf[:, 1] > 0).astype(np.int32)
        rf = RandomForest(n_trees=_CAL_TREES,
                          max_depth=_CAL_DEPTH).fit(xf, yf)
        trees = rf.trees
        trav = rf.scorer(device)
        dense = kernel = ensemble_to_gemm_mxu(rf.trees)
    t = len(trees)
    depth = max(tt.depth for tt in trees)

    dev_dense = dense.to_device(device)
    dev_kernel = kernel.to_device(device)
    times = {}
    sizes = _CAL_SIZES[backend]
    for n in sizes:
        xs = torch.as_tensor(
            rng.normal(size=(n, n_feat)).astype(np.float32),
            device=device)
        times[("trav", n)] = _time_call(trav, xs)
        times[("gemm", n)] = _time_call(
            lambda v: predict_ensemble_gemm(dev_dense, v), xs)
        if backend == "cuda":
            times[("cuda", n)] = _time_call(
                lambda v: tg_ops.tree_gemm(dev_kernel, v), xs)

    n0, n1 = sizes
    step, trav_call = _fit_linear(n0, times[("trav", n0)],
                                  n1, times[("trav", n1)])
    trav_step = step / (t * depth)
    slope, gemm_call = _fit_linear(n0, times[("gemm", n0)],
                                   n1, times[("gemm", n1)])
    gemm_flop = slope / _dense_flops_per_row(
        t, dense.a.shape[2], dense.c.shape[2], dense.e.shape[2])
    cuda_flop, cuda_call = None, 0.0
    if backend == "cuda":
        slope, cuda_call = _fit_linear(n0, times[("cuda", n0)],
                                       n1, times[("cuda", n1)])
        cuda_flop = slope / _cuda_flops_per_row(
            t, kernel.a.shape[2], kernel.c.shape[2], kernel.e.shape[2])
    return TreeStrategyCalibration(
        backend=backend, trav_step=trav_step, trav_call=trav_call,
        gemm_flop=gemm_flop, gemm_call=gemm_call,
        cuda_flop=cuda_flop, cuda_call=cuda_call)


_PROCESS_CALIBRATIONS: Dict[tuple, TreeStrategyCalibration] = {}


def calibrated_tree_costs(backend: Optional[str] = None, catalog=None,
                          model=None) -> TreeStrategyCalibration:
    """One measurement per (process, backend) on the CPU, and per
    (process, model) on the card, where ``model`` is timed at its own
    shape; the ModelStore doubles as a cross-optimizer cache so every
    instance sharing a catalog reuses it.  The card's key is
    ``("tree_strategy", "cuda", <model content fingerprint>)``: a model
    pays for its calibration once, in the plan time of its first
    ``"auto"`` query.  ``backend=None`` means the catalog's device
    (:func:`backend_of`)."""
    backend = backend or backend_of(catalog)
    key = ("tree_strategy", backend)
    if backend == "cuda" and model is not None:
        from .model_store import content_fingerprint
        key += (content_fingerprint(model),)
    else:
        model = None
    getter = getattr(catalog, "get_calibration", None)
    if getter is not None:
        cached = getter(key)
        if cached is not None:
            return cached
    cal = _PROCESS_CALIBRATIONS.get(key)
    if cal is None:
        cal = measure_tree_calibration(backend, model)
        _PROCESS_CALIBRATIONS[key] = cal
    if getter is not None:
        catalog.put_calibration(key, cal)
    return cal


def tree_strategy_costs(model, n_rows: float, n_features: int,
                        cal: TreeStrategyCalibration) -> Dict[str, float]:
    """Estimated seconds per call for each runnable inference strategy."""
    kind = getattr(model, "kind", None)
    trees = [model.tree] if kind == "decision_tree" else model.trees
    t = len(trees)
    depth = max(tt.depth for tt in trees)
    n_out = int(trees[0].n_outputs)

    def up(x, pad):
        return max(pad, ((x + pad - 1) // pad) * pad)

    max_i = max((tt.n_nodes - len(tt.leaf_indices())) for tt in trees)
    max_l = max(len(tt.leaf_indices()) for tt in trees)
    # the dense strategy pads to small multiples (gather gating needs no
    # alignment); the CUDA kernel's strategy pads to 128
    i8, l8 = up(max_i, 8), up(max_l, 8)
    i128, l128 = up(max_i, 128), up(max_l, 128)
    costs = {
        "traversal": cal.trav_call + n_rows * t * depth * cal.trav_step,
        "gemm": cal.gemm_call + n_rows * cal.gemm_flop
        * _dense_flops_per_row(t, i8, l8, n_out),
    }
    if cal.cuda_flop is not None:
        costs["cuda"] = cal.cuda_call + n_rows * cal.cuda_flop \
            * _cuda_flops_per_row(t, i128, l128, n_out)
    else:
        costs["cuda"] = float("inf")
    return costs


# A translated strategy must beat traversal's *predicted* cost by this
# factor before we abandon the incumbent.  The calibration slopes are
# best-of-3 microbenchmark fits, good to ~10% on a quiet host and worse on
# a loaded CI runner — without the margin a forest sitting near the
# crossover flips strategy run-to-run on measurement noise alone, and the
# mispredicted side of a near-tie can be ~2x slower in reality (the linear
# model ignores cache effects at forest sizes the calibration never ran).
# Traversal is the safe incumbent: it never pays padding or lowering cost.
_STRATEGY_MARGIN = 0.85


def choose_tree_strategy(model, n_rows: float, n_features: int,
                         backend: Optional[str] = None, catalog=None
                         ) -> tuple:
    """Measured crossover: pick the cheapest of traversal / dense GEMM /
    CUDA kernel for this (model, n_rows, n_features, backend), keeping
    traversal unless a translated strategy's predicted win exceeds the
    calibration-noise margin (``_STRATEGY_MARGIN``).  Returns
    ``(strategy, costs)`` so callers can log the margin."""
    cal = calibrated_tree_costs(backend, catalog, model)
    costs = tree_strategy_costs(model, n_rows, n_features, cal)
    best = min(costs, key=costs.get)
    if best != "traversal" and \
            costs[best] > _STRATEGY_MARGIN * costs["traversal"]:
        best = "traversal"
    return best, costs
