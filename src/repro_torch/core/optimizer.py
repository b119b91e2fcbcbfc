"""Raven's Cross Optimizer (paper §4.3).

An "initial version, heuristic-based, applying all rules in a specific
order" — exactly what the paper ships.  Each rule lives in
:mod:`repro_torch.core.rules` and is a pure plan-to-plan rewrite; the optimizer
clones the input plan, applies the rule list to fixpoint (bounded), and
returns the optimized plan plus a report of what fired (the report feeds
EXPERIMENTS.md and the demo notebooks).

Rule order (data flows top to bottom):

1.  ``constant_folding``        — compiler-style Expr folding
2.  ``predicate_pushdown``      — relational: filters toward scans
2b. ``partition_pruning``       — data-skipping: zone maps of partitioned
                                  tables vs pushed-down predicates skip
                                  whole partitions (feeds serve/sharded)
2c. ``distributed_plan``        — marks co-partitioned joins as
                                  partition-wise and eligible aggregations
                                  as two-phase (local/global split for the
                                  sharded executor)
3.  ``predicate_model_pruning`` — data->model: WHERE + table stats prune
                                  trees / fold one-hot groups (incl. the
                                  data-properties variant)
4.  ``projection_pushdown``     — model->data: zero-weight / unused features
                                  out of featurizers and scans
5.  ``join_elimination``        — drops joins no surviving feature needs
6.  ``model_query_splitting``   — optional: split tree+query on root predicate
7.  ``model_inlining``          — small trees -> relational CASE (UDF-inlining
                                  analogue, SQL-Server-2019-Froid style)
8.  ``nn_translation``          — remaining trees/LR/MLP -> LA operators
                                  (Hummingbird GEMM; CUDA kernel on the card)
9.  ``runtime_selection``       — pick native/external/container per operator
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ir import Plan, plan_signature

__all__ = ["OptimizerConfig", "CrossOptimizer", "OptimizationReport",
           "referenced_models"]


def referenced_models(plan: Plan) -> Tuple[str, ...]:
    """Model/pipeline names a plan references (rewrite rules preserve
    ``model_name``/``pipeline_name`` attrs through inlining and NN
    translation).  Cache invalidation keys on these: re-registering any of
    them must evict entries compiled against the plan."""
    names = set()
    for n in plan.nodes.values():
        for attr in ("model_name", "pipeline_name"):
            v = n.attrs.get(attr)
            if isinstance(v, str):
                names.add(v)
    return tuple(sorted(names))


@dataclasses.dataclass
class OptimizerConfig:
    enable_constant_folding: bool = True
    enable_predicate_pushdown: bool = True
    enable_model_pruning: bool = True
    enable_stats_pruning: bool = True
    # Zone-map partition skipping for scans of partitioned catalog tables
    # (core/partition.py).  Off for caller-supplied override tables — their
    # data need not match the registered zone maps (the serving layer
    # disables it the same way it disables stats pruning).
    enable_partition_pruning: bool = True
    # Partition-wise join / two-phase aggregation marking (core/rules/
    # distributed_plan.py).  Off for override tables for the same reason:
    # co-partitioning is a property of the *registered* data.
    enable_distributed_plan: bool = True
    # Hash-repartition exchange marking for equi-joins whose sides are
    # partition-local but *not* co-partitioned (serve/exchange.py runs the
    # shuffle).  Subordinate to enable_distributed_plan.
    enable_exchange: bool = True
    enable_projection_pushdown: bool = True
    enable_join_elimination: bool = True
    enable_model_query_splitting: bool = False   # opt-in (duplicates rows)
    enable_model_inlining: bool = True
    enable_nn_translation: bool = True
    inline_max_nodes: int = 63        # trees at most this size inline to CASE
    # Dense tree-GEMM padding multiple.  The dense (torch.matmul) strategy
    # gates via gathers and needs no alignment, so small pads waste fewer
    # flops; the "cuda" kernel strategy always pads to CUDA_PAD (128).
    gemm_pad_to: int = 8
    # Tree-inference strategy: "auto" runs the measured cost-model crossover
    # (core.cost_model.choose_tree_strategy) per (n_rows, n_trees, depth,
    # device); "traversal" / "gemm" / "cuda" force one implementation.
    tree_strategy: str = "auto"
    # Hummingbird trades FLOPs for parallel hardware: the GEMM form wins on
    # accelerators but loses to pointer-chasing traversal for *single* trees on
    # CPU (ensembles amortize either way).  "auto" = translate single trees
    # only on accelerators; paper Fig 2d shows exactly this crossover.
    nn_translate_single_trees: str = "auto"   # auto | always | never
    # Cost-based implementation choice (paper §4.3 "next step"): estimate
    # cardinalities from stats and pick traversal / CASE / GEMM per model
    # by modeled cost instead of the heuristics above.
    cost_based: bool = False
    fk_integrity: bool = True         # joins are FK joins (enables elimination)
    lossy_pushdown_tol: float = 0.0   # drop |w| <= tol (0 = exact only)
    split_imbalance: float = 0.35     # split when min-side cost share below
    max_passes: int = 3


@dataclasses.dataclass
class OptimizationReport:
    entries: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    # Structural signatures of the plan before/after optimization (see
    # ``ir.plan_signature``).  ``input_signature`` is the serving layer's
    # cache key half; ``plan_signature`` identifies the optimized artifact.
    input_signature: Optional[str] = None
    plan_signature: Optional[str] = None
    # Union of model names referenced before/after rewriting (rules may
    # replace predict_model nodes but keep the name attr; the serving layer
    # tags cache entries with these for register_model invalidation).
    referenced_models: Tuple[str, ...] = ()
    # Zone-map partition pruning outcome: table -> (surviving, total)
    # partition counts for every scan the rule pruned.
    partitions: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    # Cumulative wall seconds each rule spent across passes (EXPLAIN shows
    # where optimization time went; the cost-model calibration items read
    # the same numbers).
    rule_times: Dict[str, float] = dataclasses.field(default_factory=dict)

    def log(self, rule: str, detail: str):
        self.entries.append((rule, detail))

    def fired(self, rule: str) -> bool:
        return any(r == rule for r, _ in self.entries)

    def pretty(self) -> str:
        if not self.entries:
            return "  (no rules fired)"
        return "\n".join(f"  [{r}] {d}" for r, d in self.entries)


class CrossOptimizer:
    def __init__(self, catalog, config: Optional[OptimizerConfig] = None):
        self.catalog = catalog
        self.config = config or OptimizerConfig()

    def optimize(self, plan: Plan) -> Tuple[Plan, OptimizationReport]:
        from .rules import (constant_folding, distributed_plan,
                            join_elimination, model_inlining,
                            model_query_splitting, nn_translation,
                            partition_pruning, predicate_pruning,
                            predicate_pushdown, projection_pushdown,
                            runtime_selection, subplan_dedup)
        cfg = self.config
        report = OptimizationReport()
        if plan.output is not None:
            report.input_signature = plan_signature(plan)
        report.referenced_models = referenced_models(plan)
        plan = plan.copy()
        passes = [
            (True, subplan_dedup.apply),
            (cfg.enable_constant_folding, constant_folding.apply),
            (cfg.enable_predicate_pushdown, predicate_pushdown.apply),
            # after pushdown (filters sit on scans), before model pruning
            # (zone maps skip partitions; stats prune model internals)
            (cfg.enable_partition_pruning, partition_pruning.apply),
            # after partition pruning (surviving-partition attrs are part
            # of the distributed identity): mark co-partitioned joins and
            # two-phase aggregations for the sharded executor
            (cfg.enable_distributed_plan, distributed_plan.apply),
            (cfg.enable_model_pruning, predicate_pruning.apply),
            (cfg.enable_projection_pushdown, projection_pushdown.apply),
            (cfg.enable_join_elimination, join_elimination.apply),
            (cfg.enable_model_query_splitting, model_query_splitting.apply),
            (cfg.enable_model_inlining, model_inlining.apply),
            (cfg.enable_nn_translation, nn_translation.apply),
            (True, runtime_selection.apply),
        ]
        for _ in range(cfg.max_passes):
            changed = False
            for enabled, rule_fn in passes:
                if not enabled:
                    continue
                t0 = time.perf_counter()
                changed |= rule_fn(plan, self.catalog, cfg, report)
                plan.prune_dead()
                plan.validate()
                rule = rule_fn.__module__.rsplit(".", 1)[-1]
                report.rule_times[rule] = report.rule_times.get(rule, 0.0) \
                    + (time.perf_counter() - t0)
            if not changed:
                break
        if plan.output is not None:
            report.plan_signature = plan_signature(plan)
        report.referenced_models = tuple(sorted(
            set(report.referenced_models) | set(referenced_models(plan))))
        return plan, report
