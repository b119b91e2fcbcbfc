"""Scalar expression trees over table columns.

These are the predicate/projection expressions that appear in Raven IR
``Filter``/``Map`` nodes.  They evaluate column-at-a-time on tensors, are
introspectable (the cross-optimizer walks them to extract conjunctive
equality/range constraints for predicate-based model pruning), and foldable
(constant sub-trees are evaluated at optimization time).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "Expr", "Col", "Const", "Param", "BinOp", "UnaryOp", "CaseWhen", "col",
    "const", "lit", "param", "conjuncts", "extract_constraints", "Constraint",
    "fold_constants", "expr_params", "bind_params",
]


class Expr:
    """Base class.  Operator overloads build trees."""

    def _wrap(self, other: Any) -> "Expr":
        return other if isinstance(other, Expr) else Const(other)

    # comparisons
    def __eq__(self, other):  # type: ignore[override]
        return BinOp("==", self, self._wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinOp("!=", self, self._wrap(other))

    def __lt__(self, other):
        return BinOp("<", self, self._wrap(other))

    def __le__(self, other):
        return BinOp("<=", self, self._wrap(other))

    def __gt__(self, other):
        return BinOp(">", self, self._wrap(other))

    def __ge__(self, other):
        return BinOp(">=", self, self._wrap(other))

    # arithmetic
    def __add__(self, other):
        return BinOp("+", self, self._wrap(other))

    def __radd__(self, other):
        return BinOp("+", self._wrap(other), self)

    def __sub__(self, other):
        return BinOp("-", self, self._wrap(other))

    def __rsub__(self, other):
        return BinOp("-", self._wrap(other), self)

    def __mul__(self, other):
        return BinOp("*", self, self._wrap(other))

    def __rmul__(self, other):
        return BinOp("*", self._wrap(other), self)

    def __truediv__(self, other):
        return BinOp("/", self, self._wrap(other))

    # boolean
    def __and__(self, other):
        return BinOp("and", self, self._wrap(other))

    def __or__(self, other):
        return BinOp("or", self, self._wrap(other))

    def __invert__(self):
        return UnaryOp("not", self)

    def __hash__(self):
        return hash(repr(self))

    # -- interface ---------------------------------------------------------
    def evaluate(self, columns: Mapping[str, torch.Tensor]) -> Any:
        raise NotImplementedError

    def references(self) -> FrozenSet[str]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def evaluate(self, columns):
        return columns[self.name]

    def references(self):
        return frozenset({self.name})

    def __repr__(self):
        return f"col({self.name!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Expr):
    value: Any

    def evaluate(self, columns):
        # A python scalar, so that torch promotes it the way JAX promotes a
        # weakly-typed literal (int32 column vs 2.5 compares in float32).
        return _scalar(self.value)

    def references(self):
        return frozenset()

    def __repr__(self):
        return f"const({self.value!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Param(Expr):
    """A named query parameter — a placeholder literal bound at execution
    time, not at plan-construction time.

    The point of the node is *plan-signature stability*: it canonicalizes
    by name only, so ``age > ?`` parsed with 100 different literal values
    is one plan signature and therefore one compiled executable.  The
    runtime value travels beside the tables (the codegen layer threads a
    ``__params__`` mapping through the ``run`` closure), so every literal
    value reuses the one compiled plan.  A ``Param`` that reaches
    ``evaluate`` unbound is a programming error, reported as such.
    """

    name: str

    def evaluate(self, columns):
        raise ValueError(
            f"unbound query parameter :{self.name} — pass params= to "
            f"execute()/sql(), or bind_params() before evaluating")

    def references(self):
        return frozenset()

    def __repr__(self):
        return f"param({self.name!r})"


def param(name: str) -> Param:
    return Param(name)


def expr_params(expr: Expr) -> FrozenSet[str]:
    """Names of all :class:`Param` placeholders in ``expr``."""
    if isinstance(expr, Param):
        return frozenset({expr.name})
    if isinstance(expr, BinOp):
        return expr_params(expr.left) | expr_params(expr.right)
    if isinstance(expr, UnaryOp):
        return expr_params(expr.operand)
    if isinstance(expr, CaseWhen):
        out = expr_params(expr.default)
        for cond, val in expr.branches:
            out |= expr_params(cond) | expr_params(val)
        return out
    return frozenset()


def bind_params(expr: Expr, values: Mapping[str, Any]) -> Expr:
    """Substitute :class:`Param` nodes with the bound values.

    Values are python scalars (``codegen.resolve_params`` canonicalizes
    them); the codegen layer binds inside the executable closure, so one
    compiled plan serves every literal value.  Missing names raise
    ``KeyError`` with the parameter name, which the front door converts into
    a user-facing error.
    """
    if isinstance(expr, Param):
        if expr.name not in values:
            raise KeyError(expr.name)
        return Const(values[expr.name])
    if isinstance(expr, BinOp):
        return BinOp(expr.op, bind_params(expr.left, values),
                     bind_params(expr.right, values))
    if isinstance(expr, UnaryOp):
        return UnaryOp(expr.op, bind_params(expr.operand, values))
    if isinstance(expr, CaseWhen):
        return CaseWhen(
            tuple((bind_params(c, values), bind_params(v, values))
                  for c, v in expr.branches),
            bind_params(expr.default, values))
    return expr


def _scalar(value: Any) -> Any:
    """Python scalar for numpy scalars and 0-d arrays; anything else as is."""
    if isinstance(value, np.generic) or (
            isinstance(value, np.ndarray) and value.ndim == 0):
        return value.item()
    return value


def value_tensor(x: Any, like: Any = None) -> torch.Tensor:
    """An expression's value as a tensor (a python scalar lands on
    ``like``'s device), in the reference's 32-bit dtypes."""
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if isinstance(like, torch.Tensor) else None
    return _canon(torch.as_tensor(x, device=device))


def _canon(x: Any) -> Any:
    """Keep the JAX package's 32-bit dtypes (it runs with x64 off): torch
    makes int64 from python ints (e.g. ``where(c, 1, 0)``)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int64:
            return x.to(torch.int32)
        if x.dtype == torch.float64:
            return x.to(torch.float32)
    return x


_BINOPS: Dict[str, Callable] = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    # literals as tensors on the operand's device: torch divides by a
    # python scalar via its reciprocal (and ``2 / t`` as ``t.reciprocal()
    # * 2``), which is not the correctly rounded quotient JAX computes
    "/": lambda a, b: torch.true_divide(value_tensor(a, b), value_tensor(b, a)),
    "and": lambda a, b: torch.logical_and(value_tensor(a, b), value_tensor(b, a)),
    "or": lambda a, b: torch.logical_or(value_tensor(a, b), value_tensor(b, a)),
}

_NUMPY_BINOPS: Dict[str, Callable] = {
    **{k: v for k, v in _BINOPS.items() if k not in ("/", "and", "or")},
    "/": lambda a, b: a / b,
    "and": lambda a, b: np.logical_and(a, b),
    "or": lambda a, b: np.logical_or(a, b),
}


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def evaluate(self, columns):
        left = self.left.evaluate(columns)
        right = self.right.evaluate(columns)
        if not isinstance(left, torch.Tensor) and \
                not isinstance(right, torch.Tensor):
            # two literals: compute in 32 bits as JAX does, not in python's
            # float64
            left, right = value_tensor(left), value_tensor(right)
        return _canon(_BINOPS[self.op](left, right))

    def references(self):
        return self.left.references() | self.right.references()

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


_UNOPS: Dict[str, Callable] = {
    "not": lambda a: torch.logical_not(value_tensor(a)),
    "neg": lambda a: torch.negative(value_tensor(a)),
    "abs": lambda a: torch.abs(value_tensor(a)),
    "isnan": lambda a: torch.isnan(value_tensor(a)),
}


@dataclasses.dataclass(frozen=True, eq=False)
class UnaryOp(Expr):
    op: str
    operand: Expr

    def evaluate(self, columns):
        return _canon(_UNOPS[self.op](self.operand.evaluate(columns)))

    def references(self):
        return self.operand.references()

    def __repr__(self):
        return f"{self.op}({self.operand!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class CaseWhen(Expr):
    """SQL CASE WHEN c1 THEN v1 ... ELSE default END.

    This is the node that *model inlining* (tree -> relational) produces: a
    decision tree becomes nested CaseWhen expressions over its split
    conditions.
    """

    branches: Tuple[Tuple[Expr, Expr], ...]
    default: Expr

    def evaluate(self, columns):
        out = self.default.evaluate(columns)
        # Reverse order: the first matching WHEN wins.
        for cond, val in reversed(self.branches):
            c = value_tensor(cond.evaluate(columns))
            out = torch.where(c.to(torch.bool), val.evaluate(columns), out)
        return _canon(out)

    def references(self):
        refs = self.default.references()
        for cond, val in self.branches:
            refs |= cond.references() | val.references()
        return refs

    def __repr__(self):
        parts = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.branches)
        return f"CASE {parts} ELSE {self.default!r} END"


def col(name: str) -> Col:
    return Col(name)


def const(value: Any) -> Const:
    return Const(value)


lit = const


# ---------------------------------------------------------------------------
# Introspection helpers used by the cross-optimizer.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Constraint:
    """A single-column constraint derived from a conjunctive predicate.

    ``kind`` in {"==", "<", "<=", ">", ">=", "!="}; value is a python scalar.
    The optimizer uses these to prune decision-tree branches and to constant-
    fold one-hot features.
    """

    column: str
    kind: str
    value: Any


def conjuncts(expr: Expr) -> List[Expr]:
    """Split a predicate into top-level AND-ed conjuncts."""
    if isinstance(expr, BinOp) and expr.op == "and":
        return conjuncts(expr.left) + conjuncts(expr.right)
    return [expr]


def extract_constraints(expr: Expr) -> List[Constraint]:
    """Extract single-column constraints from the conjuncts of ``expr``.

    Only `col <op> const` / `const <op> col` conjuncts qualify; anything else
    (ORs, multi-column comparisons) is conservatively ignored — the pruning
    rules must stay sound.
    """
    out: List[Constraint] = []
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}
    for c in conjuncts(expr):
        if not isinstance(c, BinOp) or c.op not in flip:
            continue
        if isinstance(c.left, Col) and isinstance(c.right, Const):
            out.append(Constraint(c.left.name, c.op, c.right.value))
        elif isinstance(c.right, Col) and isinstance(c.left, Const):
            out.append(Constraint(c.right.name, flip[c.op], c.left.value))
    return out


def fold_constants(expr: Expr) -> Expr:
    """Compiler-style constant folding over an expression tree."""
    if isinstance(expr, BinOp):
        left = fold_constants(expr.left)
        right = fold_constants(expr.right)
        if isinstance(left, Const) and isinstance(right, Const):
            val = _NUMPY_BINOPS[expr.op](np.asarray(left.value),
                                         np.asarray(right.value))
            return Const(val.item() if np.ndim(val) == 0 else val)
        # boolean short-circuits with one constant side
        if expr.op == "and":
            for a, b in ((left, right), (right, left)):
                if isinstance(a, Const):
                    return b if bool(a.value) else Const(False)
        if expr.op == "or":
            for a, b in ((left, right), (right, left)):
                if isinstance(a, Const):
                    return Const(True) if bool(a.value) else b
        return BinOp(expr.op, left, right)
    if isinstance(expr, UnaryOp):
        operand = fold_constants(expr.operand)
        if isinstance(operand, Const):
            if expr.op == "not":
                return Const(not bool(operand.value))
            if expr.op == "neg":
                return Const(-operand.value)
            if expr.op == "abs":
                return Const(abs(operand.value))
        return UnaryOp(expr.op, operand)
    if isinstance(expr, CaseWhen):
        branches = []
        for cond, val in expr.branches:
            cond = fold_constants(cond)
            if isinstance(cond, Const):
                if bool(cond.value):
                    # This branch always fires; later branches are dead.
                    if not branches:
                        return fold_constants(val)
                    return CaseWhen(tuple(branches), fold_constants(val))
                continue  # never fires: drop
            branches.append((cond, fold_constants(val)))
        if not branches:
            return fold_constants(expr.default)
        return CaseWhen(tuple(branches), fold_constants(expr.default))
    return expr
