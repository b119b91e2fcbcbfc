"""Raven core: unified IR, frontends (SQL and Python pipelines),
cross-optimizer, codegen, model store."""

from .codegen import ExecutionConfig, compile_plan, execute, pow2_bucket
from .ir import Category, Node, Plan
from .model_store import ModelStore
from .optimizer import CrossOptimizer, OptimizationReport, OptimizerConfig
from .pipeline_frontend import analyze_script, trace_pipeline
from .sql_frontend import SqlError, SqlLookupError, parse_query

__all__ = [
    "ExecutionConfig", "compile_plan", "execute", "pow2_bucket",
    "Category", "Node", "Plan", "ModelStore",
    "CrossOptimizer", "OptimizationReport", "OptimizerConfig",
    "analyze_script", "trace_pipeline", "parse_query", "SqlError",
    "SqlLookupError",
]
