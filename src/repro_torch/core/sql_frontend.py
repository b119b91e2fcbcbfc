"""SQL frontend: parse inference queries into Raven IR (paper §3.2).

Supports the paper's query shape (SQL Server's ``PREDICT`` statement, §5):

    SELECT pid, age, PREDICT(MODEL='los_gbt') AS los
    FROM patient_info
      JOIN blood_tests ON pid
      JOIN prenatal_tests ON pid
    WHERE pregnant = 1 AND PREDICT(MODEL='los_gbt') > 7
    ORDER BY los DESC LIMIT 100

plus aggregates / GROUP BY.  ``PREDICT(MODEL='name')`` invokes a stored model
pipeline; its input columns come from the pipeline signature in the model
store.  ``PREDICT_PROBA`` yields the positive-class probability for binary
classifiers.

The translation is classic parser -> logical plan; the only novel part is how
model invocations embed: each distinct PREDICT call becomes a
``featurize -> predict_model -> attach_column`` IR chain and its expression
site is rewritten to reference the attached column, keeping scalar expressions
purely relational.

Two front-door affordances live here rather than in the serving layer:

- **Parameterized queries** — ``?`` (positional) and ``:name`` (named)
  placeholders parse into :class:`~repro_torch.relational.expr.Param` nodes, which
  canonicalize by name so that repeated queries differing only in literals
  share one plan signature (and therefore one compiled executable).  The
  parser records binding order on the returned plan as ``plan.param_order``.
- **Positioned errors** — every failure raises :class:`SqlError` carrying the
  character offset (``err.pos``) plus a caret snippet, including unknown
  tables/columns/models resolved against the catalog when it exposes schema
  (``get_table``); catalogs without schema skip name resolution.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..relational.expr import (BinOp, CaseWhen, Col, Const, Expr, Param,
                               UnaryOp)
from .ir import Category, Node, Plan

__all__ = ["parse_query", "SqlError", "SqlLookupError"]


def _format_sql_error(message: str, sql: Optional[str],
                      pos: Optional[int]) -> str:
    """Render ``message`` with a single-line caret snippet pointing at
    ``pos`` (character offset into ``sql``)."""
    if sql is None or pos is None:
        return message
    pos = max(0, min(int(pos), len(sql)))
    start = sql.rfind("\n", 0, pos) + 1
    end = sql.find("\n", pos)
    if end == -1:
        end = len(sql)
    col = pos - start
    lo = max(0, col - 48)
    hi = min(end - start, col + 48)
    snippet = sql[start + lo:start + hi]
    caret = " " * (col - lo) + "^"
    return f"{message} (at offset {pos})\n    {snippet}\n    {caret}"


class SqlError(ValueError):
    """Front-door parse/resolution error.

    ``pos`` is the character offset of the offending token in the original
    query text (always set by the parser) and ``str(err)`` includes a caret
    snippet — the contract the fuzz tests pin: *every* malformed query
    surfaces as a positioned ``SqlError``, never a raw exception.
    """

    def __init__(self, message: str, sql: Optional[str] = None,
                 pos: Optional[int] = None):
        self.message = message
        self.sql = sql
        self.pos = pos
        super().__init__(_format_sql_error(message, sql, pos))


class SqlLookupError(SqlError, KeyError):
    """Unknown table/column/model.  Doubles as :class:`KeyError` because
    that is what catalog lookups historically raised — callers written
    against the old contract (``except KeyError``) keep working, while new
    callers get the positioned caret snippet.

    ``KeyError.__str__`` (which would repr-quote the message) is shadowed
    by the explicit override so the snippet renders verbatim."""

    def __str__(self) -> str:
        return _format_sql_error(self.message, self.sql, self.pos)


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'[^']*')
  | (?P<param>\?|:[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|<>|!=|==|=|<|>|\+|-|\*|/|\(|\)|,|\.)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
""", re.VERBOSE)

_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "JOIN", "ON", "AS", "AND", "OR", "NOT",
    "GROUP", "ORDER", "BY", "ASC", "DESC", "LIMIT", "PREDICT",
    "PREDICT_PROBA", "MODEL", "SUM", "AVG", "COUNT", "MIN", "MAX", "CASE",
    "WHEN", "THEN", "ELSE", "END", "BETWEEN", "IN",
}


@dataclasses.dataclass
class Token:
    kind: str       # num | str | op | ident | kw | param
    value: Any
    pos: int = 0    # character offset of the token in the query text


def _lex(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlError(f"cannot tokenize {sql[pos:pos + 20]!r}",
                           sql=sql, pos=pos)
        start = pos
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "num":
            text = m.group()
            out.append(Token("num",
                             float(text) if "." in text else int(text),
                             start))
        elif m.lastgroup == "str":
            out.append(Token("str", m.group()[1:-1], start))
        elif m.lastgroup == "param":
            out.append(Token("param", m.group(), start))
        elif m.lastgroup == "op":
            out.append(Token("op", m.group(), start))
        else:
            word = m.group()
            if word.upper() in _KEYWORDS:
                out.append(Token("kw", word.upper(), start))
            else:
                out.append(Token("ident", word, start))
    return out


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PredictCall:
    model_name: str
    proba: bool
    placeholder: str      # column name the expression references
    pos: int = 0          # offset of the model-name literal (diagnostics)


@dataclasses.dataclass
class _SelectItem:
    expr: Optional[Expr]
    agg: Optional[Tuple[str, Optional[str]]]    # (fn, column)
    alias: str
    star: bool = False
    pos: int = 0


class _Parser:
    def __init__(self, sql: str, tokens: List[Token]):
        self.sql = sql
        self.toks = tokens
        self.i = 0
        self.predicts: List[_PredictCall] = []
        self.param_order: List[str] = []
        self._param_style: Optional[str] = None
        # first-seen offset per referenced column name, for positioned
        # unknown-column diagnostics after catalog resolution
        self.col_sites: Dict[str, int] = {}
        self.table_sites: List[Tuple[str, int]] = []

    # -- token helpers -------------------------------------------------------
    def _err(self, message: str, pos: Optional[int] = None) -> None:
        if pos is None:
            tok = self.peek()
            pos = tok.pos if tok is not None else len(self.sql)
        raise SqlError(message, sql=self.sql, pos=pos)

    def peek(self) -> Optional[Token]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Token:
        tok = self.peek()
        if tok is None:
            self._err("unexpected end of query", pos=len(self.sql))
        self.i += 1
        return tok

    def accept(self, kind: str, value: Any = None) -> Optional[Token]:
        tok = self.peek()
        if tok and tok.kind == kind and (value is None or tok.value == value):
            self.i += 1
            return tok
        return None

    def expect(self, kind: str, value: Any = None) -> Token:
        tok = self.accept(kind, value)
        if tok is None:
            got = self.peek()
            desc = f"{got.value!r}" if got is not None else "end of query"
            self._err(f"expected {value or kind}, got {desc}")
        return tok

    def _col(self, tok: Token) -> Col:
        self.col_sites.setdefault(tok.value, tok.pos)
        return Col(tok.value)

    # -- expressions ---------------------------------------------------------
    def parse_expr(self) -> Expr:
        return self._or()

    def _or(self) -> Expr:
        left = self._and()
        while self.accept("kw", "OR"):
            left = BinOp("or", left, self._and())
        return left

    def _and(self) -> Expr:
        left = self._not()
        while self.accept("kw", "AND"):
            left = BinOp("and", left, self._not())
        return left

    def _not(self) -> Expr:
        if self.accept("kw", "NOT"):
            return UnaryOp("not", self._not())
        return self._cmp()

    def _cmp(self) -> Expr:
        left = self._add()
        tok = self.peek()
        if tok and tok.kind == "op" and tok.value in (
                "=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "==", "<>": "!="}.get(tok.value, tok.value)
            return BinOp(op, left, self._add())
        if tok and tok.kind == "kw" and tok.value == "BETWEEN":
            self.next()
            lo = self._add()
            self.expect("kw", "AND")
            hi = self._add()
            return BinOp("and", BinOp(">=", left, lo), BinOp("<=", left, hi))
        return left

    def _add(self) -> Expr:
        left = self._mul()
        while True:
            tok = self.peek()
            if tok and tok.kind == "op" and tok.value in ("+", "-"):
                self.next()
                left = BinOp(tok.value, left, self._mul())
            else:
                return left

    def _mul(self) -> Expr:
        left = self._atom()
        while True:
            tok = self.peek()
            if tok and tok.kind == "op" and tok.value in ("*", "/"):
                self.next()
                left = BinOp(tok.value, left, self._atom())
            else:
                return left

    def _atom(self) -> Expr:
        tok = self.next()
        if tok.kind == "num":
            return Const(tok.value)
        if tok.kind == "str":
            return Const(tok.value)
        if tok.kind == "param":
            return self._param(tok)
        if tok.kind == "op" and tok.value == "(":
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if tok.kind == "op" and tok.value == "-":
            return UnaryOp("neg", self._atom())
        if tok.kind == "kw" and tok.value in ("PREDICT", "PREDICT_PROBA"):
            return self._predict_call(proba=tok.value == "PREDICT_PROBA")
        if tok.kind == "kw" and tok.value == "CASE":
            return self._case()
        if tok.kind == "ident":
            return self._col(tok)
        self._err(f"unexpected token {tok.value!r}", pos=tok.pos)

    def _param(self, tok: Token) -> Expr:
        if tok.value == "?":
            style = "positional"
            name = f"p{len(self.param_order)}"
            self.param_order.append(name)
        else:
            style = "named"
            name = tok.value[1:]
            if name not in self.param_order:
                self.param_order.append(name)
        if self._param_style is not None and self._param_style != style:
            self._err("cannot mix positional (?) and named (:name) "
                      "parameters in one query", pos=tok.pos)
        self._param_style = style
        return Param(name)

    def _case(self) -> Expr:
        branches = []
        while self.accept("kw", "WHEN"):
            cond = self.parse_expr()
            self.expect("kw", "THEN")
            val = self.parse_expr()
            branches.append((cond, val))
        default: Expr = Const(0.0)
        if self.accept("kw", "ELSE"):
            default = self.parse_expr()
        self.expect("kw", "END")
        return CaseWhen(tuple(branches), default)

    def _predict_call(self, proba: bool) -> Expr:
        self.expect("op", "(")
        self.expect("kw", "MODEL")
        self.expect("op", "=")
        name_tok = self.expect("str")
        name = name_tok.value
        self.expect("op", ")")
        # One attach per distinct (model, proba) call.
        for pc in self.predicts:
            if pc.model_name == name and pc.proba == proba:
                return Col(pc.placeholder)
        placeholder = f"__pred_{len(self.predicts)}_{name}"
        self.predicts.append(_PredictCall(name, proba, placeholder,
                                          name_tok.pos))
        return Col(placeholder)

    # -- query ---------------------------------------------------------------
    def parse_query(self):
        self.expect("kw", "SELECT")
        items = [self._select_item()]
        while self.accept("op", ","):
            items.append(self._select_item())
        self.expect("kw", "FROM")
        tok = self.expect("ident")
        tables = [tok.value]
        self.table_sites.append((tok.value, tok.pos))
        join_keys: List[str] = []
        while self.accept("kw", "JOIN"):
            tok = self.expect("ident")
            tables.append(tok.value)
            self.table_sites.append((tok.value, tok.pos))
            self.expect("kw", "ON")
            key_tok = self.expect("ident")
            self.col_sites.setdefault(key_tok.value, key_tok.pos)
            join_keys.append(key_tok.value)
        where = None
        if self.accept("kw", "WHERE"):
            where = self.parse_expr()
        group_by = None
        if self.accept("kw", "GROUP"):
            self.expect("kw", "BY")
            tok = self.expect("ident")
            self.col_sites.setdefault(tok.value, tok.pos)
            group_by = tok.value
        order_by = None
        descending = False
        if self.accept("kw", "ORDER"):
            self.expect("kw", "BY")
            tok = self.expect("ident")
            self.col_sites.setdefault(tok.value, tok.pos)
            order_by = tok.value
        if order_by is not None:
            if self.accept("kw", "DESC"):
                descending = True
            else:
                self.accept("kw", "ASC")
        lim = None
        if self.accept("kw", "LIMIT"):
            # LIMIT is plan-structural (it shapes the plan, not a traced
            # expression), so a parameter here binds at plan-build time:
            # bind_structural_params substitutes the integer into a plan
            # copy before signature computation, giving each distinct value
            # its own plan signature (vs expression params, which bind
            # inside one shared compiled closure).
            ptok = self.accept("param")
            if ptok is not None:
                lim = self._param(ptok)
            else:
                lim = int(self.expect("num").value)
        if self.peek() is not None:
            self._err(f"trailing tokens starting at {self.peek().value!r}")
        return items, tables, join_keys, where, group_by, \
            (order_by, descending), lim

    def _select_item(self) -> _SelectItem:
        start_tok = self.peek()
        start = start_tok.pos if start_tok is not None else len(self.sql)
        if self.accept("op", "*"):
            return _SelectItem(None, None, "*", star=True, pos=start)
        tok = self.peek()
        if tok and tok.kind == "kw" and tok.value in (
                "SUM", "AVG", "COUNT", "MIN", "MAX"):
            fn = self.next().value.lower()
            self.expect("op", "(")
            if self.accept("op", "*"):
                column = None
            else:
                col_tok = self.expect("ident")
                self.col_sites.setdefault(col_tok.value, col_tok.pos)
                column = col_tok.value
            self.expect("op", ")")
            alias = fn if column is None else f"{fn}_{column}"
            if self.accept("kw", "AS"):
                alias = self.expect("ident").value
            return _SelectItem(None, (fn, column), alias, pos=start)
        expr = self.parse_expr()
        alias = expr.name if isinstance(expr, Col) else f"expr_{self.i}"
        if self.accept("kw", "AS"):
            alias = self.expect("ident").value
        return _SelectItem(expr, None, alias, pos=start)


# ---------------------------------------------------------------------------
# IR construction
# ---------------------------------------------------------------------------

def _expr_refs_any(expr: Expr, names: Sequence[str]) -> bool:
    return bool(expr.references() & set(names))


def _catalog_columns(catalog, parser: _Parser) -> Optional[Set[str]]:
    """Union of column names across the query's tables, or ``None`` when the
    catalog cannot answer (no ``get_table`` — e.g. a bare model registry),
    in which case name resolution is skipped entirely.  Unknown *tables*
    are reported here, positioned at the table token."""
    get_table = getattr(catalog, "get_table", None)
    if get_table is None:
        return None
    known: Set[str] = set()
    for name, pos in parser.table_sites:
        try:
            table = get_table(name)
        except KeyError:
            raise SqlLookupError(f"unknown table {name!r}", sql=parser.sql,
                                     pos=pos)
        except Exception:
            return None           # catalog can't resolve schemas: skip
        names = getattr(table, "names", None)
        if names is None:
            return None
        known.update(names)
    return known


def parse_query(sql: str, catalog) -> Plan:
    """Parse ``sql`` into a Raven IR plan, resolving models via ``catalog``
    (needs ``get_model(name) -> Pipeline``; name resolution additionally
    uses ``get_table`` when present).

    The returned plan carries ``param_order`` — the tuple of parameter
    names in binding order (``?`` placeholders are auto-named ``p0, p1,
    ...``) — which the serving front door uses to bind positional
    parameter lists.  Note the attribute lives on the parsed object only;
    optimizer copies do not carry it (callers capture it at parse time).
    """
    parser = _Parser(sql, _lex(sql))
    items, tables, join_keys, where, group_by, (order_key, desc), lim = \
        parser.parse_query()

    placeholders = [p.placeholder for p in parser.predicts]

    # -- name resolution (positioned diagnostics) ---------------------------
    known = _catalog_columns(catalog, parser)
    if known is not None:
        visible = known | set(placeholders)
        aliases = {it.alias for it in items if not it.star}

        def check(names, extra=()):
            for nm in sorted(set(names) - visible - set(extra)):
                raise SqlLookupError(f"unknown column {nm!r}", sql=sql,
                                     pos=parser.col_sites.get(nm, 0))

        for key in join_keys:
            check([key])
        if where is not None:
            check(where.references())
        for it in items:
            if it.expr is not None:
                check(it.expr.references())
            elif it.agg is not None and it.agg[1] is not None:
                check([it.agg[1]])
        if group_by is not None:
            check([group_by], extra=aliases)
        if order_key is not None:
            check([order_key], extra=aliases)

    plan = Plan()
    current = plan.emit("scan", Category.RA, [], "table", table=tables[0])
    for t, key in zip(tables[1:], join_keys):
        right = plan.emit("scan", Category.RA, [], "table", table=t)
        current = plan.emit("join", Category.RA, [current, right], "table",
                            on=key, how="inner")

    # WHERE: conjuncts that don't touch predictions filter *before* the model
    # runs (paper: this enables predicate-based model pruning); conjuncts
    # referencing PREDICT output filter after attachment.  Param-bearing
    # conjuncts also go *after* the model chain even when they don't touch
    # the prediction: filtering the attached table by a model-independent
    # predicate commutes exactly with attach_column, and keeping Params out
    # of the expensive featurize/predict prefix leaves that prefix
    # result-cacheable (params only affect the cheap residual), so `:name`
    # queries get cross-query splice hits just like literal ones.
    pre_conjuncts: List[Expr] = []
    post_conjuncts: List[Expr] = []
    if where is not None:
        from ..relational.expr import conjuncts as split
        from ..relational.expr import expr_params
        for c in split(where):
            (post_conjuncts if _expr_refs_any(c, placeholders)
             or expr_params(c) else pre_conjuncts).append(c)

    def _conjoin(cs: List[Expr]) -> Expr:
        e = cs[0]
        for c in cs[1:]:
            e = BinOp("and", e, c)
        return e

    if pre_conjuncts:
        current = plan.emit("filter", Category.RA, [current], "table",
                            predicate=_conjoin(pre_conjuncts))

    # Attach one prediction column per distinct PREDICT call.
    for pc in parser.predicts:
        try:
            pipeline = catalog.get_model(pc.model_name)
        except KeyError:
            raise SqlLookupError(f"unknown model {pc.model_name!r}", sql=sql,
                                 pos=pc.pos)
        feats = plan.emit("featurize", Category.MLD, [current], "matrix",
                          pipeline_name=pc.model_name,
                          featurizers=pipeline.featurizers,
                          input_columns=pipeline.input_columns())
        pred = plan.emit("predict_model", Category.MLD, [feats], "matrix",
                         model=pipeline.model, model_name=pc.model_name,
                         proba=pc.proba, task=pipeline.metadata.task,
                         flavor=pipeline.metadata.flavor)
        current = plan.emit("attach_column", Category.RA, [current, pred],
                            "table", name=pc.placeholder)

    if post_conjuncts:
        current = plan.emit("filter", Category.RA, [current], "table",
                            predicate=_conjoin(post_conjuncts))

    if group_by is not None:
        aggs = {}
        for it in items:
            if it.agg is not None:
                aggs[it.alias] = it.agg
            elif it.expr is not None and isinstance(it.expr, Col) \
                    and it.expr.name == group_by:
                pass
            elif not it.star:
                raise SqlError(
                    f"non-aggregated select item {it.alias!r} with GROUP BY",
                    sql=sql, pos=it.pos)
        current = plan.emit("group_agg", Category.RA, [current], "table",
                            key=group_by, aggs=aggs)
    else:
        # extended projection for computed items
        computed = [(it.alias, it.expr) for it in items
                    if it.expr is not None and not isinstance(it.expr, Col)]
        for alias, expr in computed:
            current = plan.emit("map", Category.RA, [current], "table",
                                name=alias, expr=expr)
        if any(it.agg for it in items):
            aggs = {it.alias: it.agg for it in items if it.agg}
            current = plan.emit("group_agg", Category.RA, [current], "table",
                                key=None, aggs=aggs)

    if order_key is not None:
        current = plan.emit("order_by", Category.RA, [current], "table",
                            key=order_key, descending=desc)
    if lim is not None:
        current = plan.emit("limit", Category.RA, [current], "table", n=lim)

    # final projection
    if group_by is None and not any(it.agg for it in items) \
            and not any(it.star for it in items):
        names = []
        for it in items:
            if isinstance(it.expr, Col) and it.alias == it.expr.name:
                names.append(it.expr.name)
            else:
                names.append(it.alias)
        # rename prediction placeholders chosen via AS
        renames = {it.expr.name: it.alias for it in items
                   if isinstance(it.expr, Col) and it.alias != it.expr.name}
        if renames:
            current = plan.emit("rename", Category.RA, [current], "table",
                                mapping=renames)
        current = plan.emit("project", Category.RA, [current], "table",
                            columns=names)

    plan.output = current
    plan.validate()
    plan.param_order = tuple(parser.param_order)
    return plan
