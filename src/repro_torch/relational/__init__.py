"""Columnar relational engine in plain torch (mask-based bag semantics)."""

from .expr import (CaseWhen, Col, Const, Constraint, Expr, Param, bind_params,
                   col, conjuncts, const, expr_params, extract_constraints,
                   fold_constants, lit, param)
from .ops import (filter_, group_aggregate, join_unique, limit, order_by,
                  project, union_all, with_column)
from .table import ColumnSchema, Schema, Table

__all__ = [
    "CaseWhen", "Col", "Const", "Constraint", "Expr", "Param", "bind_params",
    "col", "conjuncts", "const", "expr_params", "extract_constraints",
    "fold_constants", "lit", "param",
    "filter_", "group_aggregate", "join_unique", "limit", "order_by",
    "project", "union_all", "with_column",
    "ColumnSchema", "Schema", "Table",
]
