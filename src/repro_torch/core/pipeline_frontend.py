"""Static analysis of imperative (Python) model pipelines (paper §3.2).

The paper's Static Analyzer performs "lexing, parsing, extraction of variables
and their scopes, semantic analysis, type inference, and finally extraction of
control and data flows", then compiles the dataflow onto IR operators using a
knowledge base of data-science APIs.  This module implements that process for
the same scope the paper automated — straight-line pandas/sklearn-style
scripts — with the same fallback: anything outside the knowledge base becomes
a UDF operator.

Two entry points:

- :func:`trace_pipeline` — object-level analysis: a fitted
  :class:`repro_torch.ml.Pipeline` is decomposed into featurize/predict IR nodes
  (the common path, used by the SQL frontend).
- :func:`analyze_script` — source-level analysis: a restricted Python script
  is parsed with ``ast``; assignments are tracked through a dataflow
  environment typed as {table, matrix, vector}; knowledge-base calls
  (``load_table``, ``DataFrame.merge``, boolean-mask filters,
  ``pipeline.transform``, ``model.predict``, column assignment) map to IR
  nodes.  Loops and conditionals are rejected into UDFs exactly as the paper
  prescribes (~17 % of notebook cells in their corpus; §3.2).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..relational.expr import BinOp, Col, Const, Expr, UnaryOp
from .ir import Category, Node, Plan

__all__ = ["trace_pipeline", "analyze_script", "StaticAnalysisError"]


class StaticAnalysisError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Object-level analysis
# ---------------------------------------------------------------------------

def trace_pipeline(plan: Plan, table_node: str, pipeline, model_name: str,
                   output_name: str, proba: bool = False) -> str:
    """Expand a fitted Pipeline into featurize -> predict -> attach nodes."""
    feats = plan.emit("featurize", Category.MLD, [table_node], "matrix",
                      pipeline_name=model_name,
                      featurizers=pipeline.featurizers,
                      input_columns=pipeline.input_columns())
    pred = plan.emit("predict_model", Category.MLD, [feats], "matrix",
                     model=pipeline.model, model_name=model_name,
                     proba=proba, task=pipeline.metadata.task,
                     flavor=pipeline.metadata.flavor)
    return plan.emit("attach_column", Category.RA, [table_node, pred],
                     "table", name=output_name)


# ---------------------------------------------------------------------------
# Source-level analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Binding:
    node_id: Optional[str]     # IR node producing this value (if dataflow)
    kind: str                  # table | matrix | vector | scalar | obj
    obj: Any = None            # for catalog objects (models, pipelines)


_CMP_OPS = {ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
            ast.Gt: ">", ast.GtE: ">="}
_BIN_OPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}
_BOOL_OPS = {ast.And: "and", ast.Or: "or"}


class _ScriptAnalyzer(ast.NodeVisitor):
    """Single pass over straight-line statements; builds a Plan."""

    def __init__(self, catalog, objects: Dict[str, Any]):
        self.catalog = catalog
        self.plan = Plan()
        self.env: Dict[str, _Binding] = {
            name: _Binding(None, "obj", obj) for name, obj in objects.items()
        }
        self.udf_count = 0

    # -- expression -> relational Expr (column space) -----------------------
    def to_expr(self, node: ast.AST, frame: str) -> Expr:
        """Convert a mask/arith expression over ``frame`` columns."""
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise StaticAnalysisError("chained comparisons unsupported")
            op = _CMP_OPS.get(type(node.ops[0]))
            if op is None:
                raise StaticAnalysisError(f"comparison {node.ops[0]}")
            return BinOp(op, self.to_expr(node.left, frame),
                         self.to_expr(node.comparators[0], frame))
        if isinstance(node, ast.BoolOp):
            op = _BOOL_OPS[type(node.op)]
            parts = [self.to_expr(v, frame) for v in node.values]
            e = parts[0]
            for p in parts[1:]:
                e = BinOp(op, e, p)
            return e
        if isinstance(node, ast.BinOp):
            # pandas boolean masks use & / |
            if isinstance(node.op, ast.BitAnd):
                return BinOp("and", self.to_expr(node.left, frame),
                             self.to_expr(node.right, frame))
            if isinstance(node.op, ast.BitOr):
                return BinOp("or", self.to_expr(node.left, frame),
                             self.to_expr(node.right, frame))
            op = _BIN_OPS.get(type(node.op))
            if op is None:
                raise StaticAnalysisError(f"operator {node.op}")
            return BinOp(op, self.to_expr(node.left, frame),
                         self.to_expr(node.right, frame))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return UnaryOp("not", self.to_expr(node.operand, frame))
        if isinstance(node, ast.Subscript):
            # df['col']
            base = node.value
            if isinstance(base, ast.Name) and base.id == frame and \
                    isinstance(node.slice, ast.Constant):
                return Col(node.slice.value)
            raise StaticAnalysisError("unsupported subscript in expression")
        if isinstance(node, ast.Attribute):
            # df.col
            if isinstance(node.value, ast.Name) and node.value.id == frame:
                return Col(node.attr)
            raise StaticAnalysisError("unsupported attribute in expression")
        if isinstance(node, ast.Constant):
            return Const(node.value)
        raise StaticAnalysisError(f"unsupported expression {ast.dump(node)}")

    # -- statements -----------------------------------------------------------
    def analyze(self, source: str) -> Plan:
        tree = ast.parse(source)
        for stmt in tree.body:
            self.visit_stmt(stmt)
        return self.plan

    def visit_stmt(self, stmt: ast.stmt):
        # Control flow -> UDF fallback, per paper §3.2.
        if isinstance(stmt, (ast.For, ast.While, ast.If, ast.FunctionDef,
                             ast.With, ast.Try)):
            self._fallback_udf(stmt)
            return
        if isinstance(stmt, ast.Assign):
            if len(stmt.targets) != 1:
                raise StaticAnalysisError("multi-target assignment")
            target = stmt.targets[0]
            if isinstance(target, ast.Name):
                self.env[target.id] = self.eval_value(stmt.value, target.id)
                return
            if isinstance(target, ast.Subscript):
                self._column_assign(target, stmt.value)
                return
        if isinstance(stmt, ast.Expr):
            self.eval_value(stmt.value, "_")
            return
        raise StaticAnalysisError(f"unsupported statement {ast.dump(stmt)}")

    def _column_assign(self, target: ast.Subscript, value: ast.expr):
        # df['los'] = pred  OR df['x'] = <expr over df columns>
        frame_name = target.value.id          # type: ignore[attr-defined]
        colname = target.slice.value          # type: ignore[attr-defined]
        frame = self.env[frame_name]
        if frame.kind != "table":
            raise StaticAnalysisError(f"{frame_name} is not a table")
        if isinstance(value, ast.Name) and \
                self.env.get(value.id, _Binding(None, "?")).kind == "vector":
            vec = self.env[value.id]
            nid = self.plan.emit("attach_column", Category.RA,
                                 [frame.node_id, vec.node_id], "table",
                                 name=colname)
        else:
            expr = self.to_expr(value, frame_name)
            nid = self.plan.emit("map", Category.RA, [frame.node_id],
                                 "table", name=colname, expr=expr)
        self.env[frame_name] = _Binding(nid, "table")
        self.plan.output = nid

    def eval_value(self, value: ast.expr, hint: str) -> _Binding:
        # load_table('name')
        if isinstance(value, ast.Call):
            return self._call(value)
        # df[mask]
        if isinstance(value, ast.Subscript):
            base = value.value
            if isinstance(base, ast.Name):
                binding = self.env.get(base.id)
                if binding is not None and binding.kind == "table":
                    pred = self.to_expr(value.slice, base.id)
                    nid = self.plan.emit("filter", Category.RA,
                                         [binding.node_id], "table",
                                         predicate=pred)
                    self.plan.output = nid
                    return _Binding(nid, "table")
        if isinstance(value, ast.Name):
            if value.id in self.env:
                return self.env[value.id]
        raise StaticAnalysisError(f"unsupported value {ast.dump(value)}")

    def _call(self, call: ast.Call) -> _Binding:
        fn = call.func
        # load_table('x')
        if isinstance(fn, ast.Name) and fn.id == "load_table":
            tname = call.args[0].value    # type: ignore[attr-defined]
            nid = self.plan.emit("scan", Category.RA, [], "table",
                                 table=tname)
            self.plan.output = nid
            return _Binding(nid, "table")
        if isinstance(fn, ast.Attribute):
            owner_name = fn.value.id if isinstance(fn.value, ast.Name) else None
            owner = self.env.get(owner_name) if owner_name else None
            # df.merge(df2, on='pid')
            if fn.attr == "merge" and owner and owner.kind == "table":
                right = self.env[call.args[0].id]   # type: ignore
                on = next(kw.value.value for kw in call.keywords
                          if kw.arg == "on")
                nid = self.plan.emit("join", Category.RA,
                                     [owner.node_id, right.node_id], "table",
                                     on=on, how="inner")
                self.plan.output = nid
                return _Binding(nid, "table")
            # pipeline.transform(df) -> featurize
            if fn.attr == "transform" and owner and owner.kind == "obj":
                frame = self.env[call.args[0].id]   # type: ignore
                pipe = owner.obj
                nid = self.plan.emit(
                    "featurize", Category.MLD, [frame.node_id], "matrix",
                    pipeline_name=getattr(pipe.metadata, "name", "pipeline"),
                    featurizers=pipe.featurizers,
                    input_columns=pipe.input_columns())
                return _Binding(nid, "matrix")
            # model.predict(X) / predict_proba(X)
            if fn.attr in ("predict", "predict_proba") and owner \
                    and owner.kind == "obj":
                x = self.env[call.args[0].id]       # type: ignore
                obj = owner.obj
                model = obj.model if hasattr(obj, "model") else obj
                task = obj.metadata.task if hasattr(obj, "metadata") \
                    else "classification"
                if x.kind == "table":
                    # whole-pipeline predict on a frame
                    feats = self.plan.emit(
                        "featurize", Category.MLD, [x.node_id], "matrix",
                        pipeline_name=owner_name,
                        featurizers=obj.featurizers,
                        input_columns=obj.input_columns())
                    src = feats
                else:
                    src = x.node_id
                nid = self.plan.emit(
                    "predict_model", Category.MLD, [src], "matrix",
                    model=model, model_name=owner_name,
                    proba=fn.attr == "predict_proba", task=task,
                    flavor=getattr(getattr(obj, "metadata", None), "flavor",
                                   "repro.native"))
                return _Binding(nid, "vector")
        # unknown call -> UDF
        return self._fallback_udf(call)

    def _fallback_udf(self, node: ast.AST) -> _Binding:
        self.udf_count += 1
        src = ast.unparse(node)
        # find a table in scope to hang the UDF on
        frames = [b for b in self.env.values() if b.kind == "table"
                  and b.node_id]
        inputs = [frames[-1].node_id] if frames else []

        def udf_fn(payload):
            raise NotImplementedError(
                f"UDF stub for untranslatable code: {src!r}")

        nid = self.plan.emit("udf", Category.UDF, inputs, "vector",
                             fn=udf_fn, source=src)
        return _Binding(nid, "vector")


def analyze_script(source: str, catalog,
                   objects: Optional[Dict[str, Any]] = None
                   ) -> Tuple[Plan, int]:
    """Statically analyze a Python pipeline script.

    ``objects`` binds free names (models/pipelines the script references) to
    fitted artifacts from the model store.  Returns (plan, n_udf_fallbacks).
    """
    analyzer = _ScriptAnalyzer(catalog, dict(objects or {}))
    plan = analyzer.analyze(source)
    plan.validate()
    return plan, analyzer.udf_count
