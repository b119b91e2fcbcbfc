"""Cross-optimizer transformation rules (paper §4)."""

from . import (constant_folding, distributed_plan, join_elimination,
               model_inlining, model_query_splitting, nn_translation,
               partition_pruning, predicate_pruning, predicate_pushdown,
               projection_pushdown, runtime_selection, subplan_dedup)

__all__ = [
    "constant_folding", "distributed_plan", "join_elimination",
    "model_inlining", "model_query_splitting", "nn_translation",
    "partition_pruning", "predicate_pruning", "predicate_pushdown",
    "projection_pushdown", "runtime_selection", "subplan_dedup",
]
