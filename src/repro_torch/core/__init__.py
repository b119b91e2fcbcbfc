"""Raven core: unified IR, SQL frontend, cross-optimizer, codegen, model
store."""

from .codegen import ExecutionConfig, compile_plan, execute
from .ir import Category, Node, Plan
from .model_store import ModelStore
from .optimizer import CrossOptimizer, OptimizationReport, OptimizerConfig
from .sql_frontend import SqlError, SqlLookupError, parse_query

__all__ = [
    "ExecutionConfig", "compile_plan", "execute",
    "Category", "Node", "Plan", "ModelStore",
    "CrossOptimizer", "OptimizationReport", "OptimizerConfig",
    "parse_query", "SqlError", "SqlLookupError",
]
