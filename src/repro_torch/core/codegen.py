"""Runtime code generation: optimized Raven IR -> executable torch (paper §5).

The paper's Runtime Code Generator emits a SQL query whose model invocations
execute in-process (ONNX Runtime inside SQL Server), out-of-process
(``sp_execute_external_script``) or in a container.  Here the three execution
modes map to:

- **native** (in-process): the operator runs on the tables' device inside
  the same closure as the relational plan.
- **external** (out-of-process): the operator runs host-side on numpy
  inputs — a real device->host->device boundary with real transfer costs,
  mirroring Raven Ext.
- **container**: like external plus a configurable injected latency
  simulating the REST hop of a containerized runtime (no real containers
  are spun up).

``compile_plan`` returns a callable ``fn(tables) -> Table``; ``execute`` runs
a plan against the catalog's registered tables.  Execution is eager (there
is no jit): the closure runs on the device of the tables it gets.  Model
constants (featurizer statistics, trees, ensemble matrices, weights) are
placed on the device once, when the closure is built for the catalog's
device (or at the first call on another device) — never per query.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..relational import ops as rel_ops
from ..relational.expr import bind_params
from ..relational.table import Table, to_numpy
from .ir import Plan, plan_params

__all__ = ["compile_plan", "execute", "resolve_params", "ExecutionConfig",
           "compile_stats", "reset_compile_stats", "add_compile_listener",
           "add_trace_listener", "count_jit_trace"]


class ExecutionConfig:
    """Knobs for non-native runtimes and the tree-GEMM kernel.

    ``use_cuda_tree_gemm`` forces every ``tree_gemm`` node through the
    hand-written CUDA kernel (``kernels/tree_gemm``) whatever strategy the
    optimizer recorded — the benchmark override.  The partition-parallel
    knobs of the JAX package's config arrive with the sharded executor.
    """

    def __init__(self, container_latency_s: float = 0.05,
                 external_latency_s: float = 0.0,
                 use_cuda_tree_gemm: bool = False):
        self.container_latency_s = container_latency_s
        self.external_latency_s = external_latency_s
        self.use_cuda_tree_gemm = use_cuda_tree_gemm


# Observability hooks: every compile_plan() call counts under
# ``plans_compiled``.  ``jit_traces`` counts shape-specialized recompiles
# of a serving executable in the JAX package; execution here is eager, so
# nothing increments it yet — the counter and its listener seam stay so
# the serving layer keeps one metrics surface.
compile_stats: Dict[str, int] = {"plans_compiled": 0, "jit_traces": 0}
_compile_listeners: List[Callable[[Plan], None]] = []
_trace_listeners: List[Callable[[], None]] = []


def reset_compile_stats() -> None:
    compile_stats["plans_compiled"] = 0
    compile_stats["jit_traces"] = 0


def count_jit_trace() -> None:
    """Record one shape-specialized compilation of a serving executable."""
    compile_stats["jit_traces"] += 1
    for listener in list(_trace_listeners):
        listener()


def add_compile_listener(fn: Callable[[Plan], None]) -> Callable[[], None]:
    """Register a hook fired on every compile_plan; returns an unsubscriber."""
    _compile_listeners.append(fn)
    return lambda: _compile_listeners.remove(fn)


def add_trace_listener(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a hook fired on every ``count_jit_trace``; returns an
    unsubscriber."""
    _trace_listeners.append(fn)
    return lambda: _trace_listeners.remove(fn)


def _native_scorer(model, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Raw scores [n, k] for any supported model kind, with the model's
    constants placed on ``device``."""
    kind = getattr(model, "kind", None)
    if kind in ("decision_tree", "random_forest", "mlp"):
        return model.scorer(device)
    if kind in ("gbt", "linear_regression", "logistic_regression"):
        score = model.scorer(device)
        return lambda x: score(x)[:, None]
    raise ValueError(f"unknown model kind {kind}")


def _scores_to_output(scores: torch.Tensor, task: str, proba: bool
                      ) -> torch.Tensor:
    """[n, k] scores -> [n] prediction column."""
    if scores.shape[-1] == 1:
        col = scores[:, 0]
        if task == "classification":
            if proba:
                return torch.sigmoid(col)
            return (col > 0).to(torch.float32)
        return col
    if task == "classification":
        if proba:
            return torch.softmax(scores, dim=-1)[:, 1]
        return torch.argmax(scores, dim=-1).to(torch.float32)
    return scores[:, 0]


# ---------------------------------------------------------------------------
# External / container runtime: pure-numpy host evaluation.
#
# Raven Ext evaluates the model in a *separate* runtime
# (sp_execute_external_script / ONNX in a container), not in the database
# engine's compute stream: the features leave the device, are scored by
# numpy on the host, and the column comes back.  Model parameters are
# snapshotted to host numpy once at closure-build time.
# ---------------------------------------------------------------------------

def _np_sigmoid(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x, dtype=np.float32)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _tree_scores_np(tree, x: np.ndarray) -> np.ndarray:
    """Vectorized numpy twin of tensor traversal (same fixed depth-bounded
    traversal, so identical leaf assignment)."""
    n = x.shape[0]
    node = np.zeros((n,), np.int32)
    rows = np.arange(n)
    for _ in range(max(tree.depth, 1)):
        is_leaf = tree.left[node] < 0
        go_left = x[rows, tree.feature[node]] <= tree.threshold[node]
        nxt = np.where(go_left, tree.left[node], tree.right[node])
        node = np.where(is_leaf, node, nxt).astype(np.int32)
    return tree.value[node]


def _np_model_fn(model):
    """Build a ``numpy [n, d] -> numpy [n, k]`` scorer with every
    parameter already host-resident."""
    kind = getattr(model, "kind", None)
    if kind == "decision_tree":
        tree = model.tree
        return lambda x: _tree_scores_np(tree, x)
    if kind == "random_forest":
        trees = list(model.trees)
        return lambda x: sum(_tree_scores_np(t, x) for t in trees) \
            / len(trees)
    if kind == "gbt":
        trees, base, lr = list(model.trees), model.base, model.learning_rate

        def gbt(x):
            out = np.full((x.shape[0],), base, np.float32)
            for t in trees:
                out = out + lr * _tree_scores_np(t, x)[:, 0]
            return out[:, None]
        return gbt
    if kind in ("linear_regression", "logistic_regression"):
        w = np.asarray(model.weights, np.float32)
        b = np.float32(model.bias)
        return lambda x: (x @ w + b)[:, None]
    if kind == "mlp":
        layers = [(np.asarray(p["w"], np.float32),
                   np.asarray(p["b"], np.float32)) for p in model.params]

        def mlp(x):
            h = x
            for i, (w, b) in enumerate(layers):
                h = h @ w + b
                if i < len(layers) - 1:
                    h = np.maximum(h, 0.0)
            return h
        return mlp
    raise ValueError(f"unknown model kind {kind}")


def _scores_to_output_np(scores: np.ndarray, task: str,
                         proba: bool) -> np.ndarray:
    """numpy twin of :func:`_scores_to_output`."""
    if scores.shape[-1] == 1:
        col = scores[:, 0]
        if task == "classification":
            if proba:
                return _np_sigmoid(col)
            return (col > 0).astype(np.float32)
        return col
    if task == "classification":
        if proba:
            e = np.exp(scores - scores.max(axis=-1, keepdims=True))
            return (e / e.sum(axis=-1, keepdims=True))[:, 1]
        return np.argmax(scores, axis=-1).astype(np.float32)
    return scores[:, 0]


def _external_predict(model, task: str, proba: bool, latency_s: float):
    """Host-side (numpy) model evaluation — the Raven Ext / container
    execution path."""
    score_fn = _np_model_fn(model)

    def call(x: torch.Tensor) -> torch.Tensor:
        if latency_s > 0:
            time.sleep(latency_s)
        host = to_numpy(x).astype(np.float32)
        out = np.asarray(_scores_to_output_np(score_fn(host), task, proba),
                         np.float32)
        return torch.from_numpy(out).to(x.device)

    return call


def _stage(nodes, order, config: "ExecutionConfig",
           device: torch.device) -> Dict[str, Any]:
    """Per-node constants placed on ``device``: bound featurizers, model
    scorers, ensemble matrices, weights.  Done once per (plan, device)."""
    staged: Dict[str, Any] = {}
    for nid in order:
        n = nodes[nid]
        a = n.attrs
        if n.op == "featurize":
            staged[nid] = [f.bind(device) for f in a["featurizers"]]
        elif n.op == "gather_features":
            staged[nid] = torch.as_tensor(
                np.asarray(a["indices"], np.int64), device=device)
        elif n.op == "predict_model":
            task = a.get("task", "classification")
            proba = a.get("proba", False)
            if n.runtime == "native":
                staged[nid] = _native_scorer(a["model"], device)
            else:
                latency = config.external_latency_s \
                    if n.runtime == "external" else config.container_latency_s
                staged[nid] = _external_predict(a["model"], task, proba,
                                                latency)
        elif n.op == "affine":
            staged[nid] = (
                torch.as_tensor(np.asarray(a["scale"], np.float32),
                                device=device),
                torch.as_tensor(np.asarray(a["offset"], np.float32),
                                device=device))
        elif n.op == "matmul_bias":
            staged[nid] = (
                torch.as_tensor(np.asarray(a["weights"], np.float32),
                                device=device),
                torch.as_tensor(np.asarray(a["bias"], np.float32),
                                device=device))
        elif n.op == "tree_gemm":
            staged[nid] = a["ensemble"].to_device(device)
    return staged


def _device_of(tables: Dict[str, Any]) -> Optional[torch.device]:
    for name, v in tables.items():
        if name != "__params__" and hasattr(v, "device"):
            return torch.device(v.device)
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compile_plan(plan: Plan, catalog,
                 config: Optional[ExecutionConfig] = None,
                 capture: Optional[str] = None,
                 node_hook: Optional[Callable[[str, Any, Any, float],
                                              None]] = None
                 ) -> Callable[[Dict[str, Table]], Any]:
    """Build the executable closure for ``plan``.

    The returned function is pure in its table inputs: model parameters are
    part of the *compiled query* (the paper's model+inference-session
    caching), placed on the catalog's device here, once.

    ``capture`` names a node whose intermediate value the caller wants
    alongside the output: the function then returns ``(output, captured)``.

    Plans may contain ``materialized`` nodes: leaves that read a previously
    captured value injected through the tables dict under ``attrs['slot']``.

    ``node_hook(nid, node, value, elapsed_s)`` turns the closure into an
    instrumented op-at-a-time profiler: after each node the device is
    synchronized and the hook observes the node's wall time.  This is the
    EXPLAIN ANALYZE seam.
    """
    config = config or ExecutionConfig()
    compile_stats["plans_compiled"] += 1
    for listener in list(_compile_listeners):
        listener(plan)
    order = plan.topo_order()
    nodes = plan.nodes
    # Filter/map nodes holding Param placeholders bind them *inside* the
    # closure, against the reserved ``__params__`` entry of the tables dict,
    # so one compiled plan serves every literal binding.
    parametric = {nid for nid in order
                  if nodes[nid].op in ("filter", "map")
                  and plan_params(plan, [nid])}

    staged_by_device: Dict[torch.device, Dict[str, Any]] = {}

    def constants(device: torch.device) -> Dict[str, Any]:
        staged = staged_by_device.get(device)
        if staged is None:
            staged = staged_by_device[device] = _stage(nodes, order, config,
                                                       device)
        return staged

    home = getattr(catalog, "device", None)
    if home is not None:
        constants(torch.device(home))

    def run(tables: Dict[str, Table]) -> Any:
        device = _device_of(tables) or torch.device(home or "cpu")
        consts = constants(device)
        env: Dict[str, Any] = {}

        def bound(expr):
            try:
                return bind_params(expr, tables.get("__params__") or {})
            except KeyError as k:
                raise ValueError(
                    f"unbound query parameter {k.args[0]!r}: pass "
                    f"params= with a value for it") from None

        for nid in order:
            n = nodes[nid]
            op = n.op
            ins = [env[i] for i in n.inputs]
            a = n.attrs
            if node_hook is not None:
                _sync(device)
                t0 = time.perf_counter()
            if op == "scan":
                env[nid] = tables[a["table"]]
            elif op == "materialized":
                env[nid] = tables[a["slot"]]
            elif op == "filter":
                pred = a["predicate"]
                if nid in parametric:
                    pred = bound(pred)
                env[nid] = rel_ops.filter_(ins[0], pred)
            elif op == "project":
                env[nid] = rel_ops.project(ins[0], a["columns"])
            elif op == "rename":
                t = ins[0]
                mapping = a["mapping"]
                cols = {mapping.get(k, k): v for k, v in t.columns.items()}
                env[nid] = Table(cols, t.valid, t.schema.rename(mapping))
            elif op == "map":
                expr = a["expr"]
                if nid in parametric:
                    expr = bound(expr)
                env[nid] = rel_ops.with_column(ins[0], a["name"], expr)
            elif op == "join":
                env[nid] = rel_ops.join_unique(ins[0], ins[1], on=a["on"],
                                               how=a.get("how", "inner"))
            elif op == "group_agg":
                env[nid] = rel_ops.group_aggregate(
                    ins[0], a["key"], a["aggs"], a.get("num_groups"))
            elif op == "partial_agg":
                # local phase of a two-phase aggregation: mergeable state
                # per morsel; the sharded executor runs the combine stage
                env[nid] = rel_ops.partial_aggregate(
                    ins[0], a["key"], a["aggs"], a.get("num_groups"))
            elif op == "order_by":
                env[nid] = rel_ops.order_by(ins[0], a["key"],
                                            a.get("descending", False))
            elif op == "limit":
                env[nid] = rel_ops.limit(ins[0], a["n"])
            elif op == "union":
                env[nid] = rel_ops.union_all(ins[0], ins[1])
            elif op == "attach_column":
                t, vec = ins
                if vec.ndim == 2:
                    vec = vec[:, 0]
                env[nid] = t.with_columns({a["name"]: vec})
            elif op == "featurize":
                table = ins[0]
                feats = [f(table.columns) for f in consts[nid]]
                env[nid] = torch.cat(feats, dim=1)
            elif op == "gather_features":
                env[nid] = ins[0][:, consts[nid]]
            elif op == "predict_model":
                scores_or_col = consts[nid](ins[0])
                if n.runtime == "native":
                    env[nid] = _scores_to_output(
                        scores_or_col, a.get("task", "classification"),
                        a.get("proba", False))
                else:   # external / container return the column
                    env[nid] = scores_or_col
            # ---- LA ops produced by NN-translation / pruning rules ----------
            elif op == "affine":
                scale, offset = consts[nid]
                env[nid] = ins[0] * scale + offset
            elif op == "matmul_bias":
                w, b = consts[nid]
                env[nid] = ins[0] @ w + b
            elif op == "sigmoid":
                env[nid] = torch.sigmoid(ins[0])
            elif op == "relu":
                env[nid] = torch.relu(ins[0])
            elif op == "softmax":
                env[nid] = torch.softmax(ins[0], dim=-1)
            elif op == "argmax":
                env[nid] = torch.argmax(ins[0], dim=-1).to(torch.float32)
            elif op == "select_column":
                env[nid] = ins[0][:, a["index"]]
            elif op == "threshold":
                env[nid] = (ins[0] > a["value"]).to(torch.float32)
            elif op == "tree_gemm":
                # Strategy chosen by the cost-model crossover at plan time
                # (nn_translation); ``use_cuda_tree_gemm`` force-overrides
                # for benchmarks.  The strategy attr participates in the
                # plan signature, so differently-lowered plans never share
                # a cached executable.
                strategy = a.get("strategy", "gemm")
                if config.use_cuda_tree_gemm or strategy == "cuda":
                    from ..kernels.tree_gemm import ops as tg_ops
                    scores = tg_ops.tree_gemm(consts[nid], ins[0])
                else:
                    from ..ml.hummingbird import predict_ensemble_gemm
                    scores = predict_ensemble_gemm(consts[nid], ins[0])
                bias = a.get("bias", 0.0)
                if bias != 0.0:
                    scores = scores + bias
                env[nid] = _scores_to_output(
                    scores, a.get("task", "classification"),
                    a.get("proba", False))
            elif op == "constant_vector":
                n_rows = ins[0].shape[0] if isinstance(ins[0], torch.Tensor) \
                    else ins[0].capacity
                env[nid] = torch.full((n_rows,), a["value"],
                                      dtype=torch.float32, device=device)
            elif op == "udf":
                fn = a["fn"]
                out_dtype = a.get("dtype", np.float32)
                x = ins[0]
                if hasattr(x, "columns"):   # table input: pass column dict
                    host = fn({k: to_numpy(v) for k, v in x.columns.items()})
                else:
                    host = fn(to_numpy(x))
                env[nid] = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(host, out_dtype))
                ).to(device)
            else:
                raise ValueError(f"codegen: unknown op {op}")
            if node_hook is not None:
                _sync(device)
                node_hook(nid, n, env[nid], time.perf_counter() - t0)
        if capture is not None:
            return env[plan.output], env[capture]
        return env[plan.output]

    return run


_STRUCTURAL_PARAM_ATTRS = {"limit": ("n",)}


def bind_structural_params(plan: Plan, bound: Optional[Dict[str, Any]]
                           ) -> Tuple[Plan, Optional[Dict[str, Any]]]:
    """Substitute bindings for *plan-structural* parameters (``LIMIT :n``)
    into a copy of the plan at plan-build time.

    Expression parameters bind inside the closure, so every binding shares
    one plan signature and one executable.  Structural parameters shape the
    plan itself; they are bound here instead, which deliberately gives each
    distinct value its own plan signature.  Returns ``(plan,
    residual_bound)`` with consumed names dropped from the binding dict; a
    no-op (same plan object) when nothing is structural.
    """
    from ..relational.expr import Param
    if not bound:
        return plan, bound
    sites = []
    for n in plan.nodes.values():
        for attr in _STRUCTURAL_PARAM_ATTRS.get(n.op, ()):
            v = n.attrs.get(attr)
            if isinstance(v, Param):
                sites.append((n.id, attr, v.name))
    if not sites:
        return plan, bound
    out = plan.copy()
    for nid, attr, name in sites:
        out.nodes[nid].attrs[attr] = int(bound[name])
    # a name used only structurally is fully consumed; one also referenced
    # by an expression (e.g. WHERE x > :n LIMIT :n) stays bound
    remaining = plan_params(out)
    residual = {k: v for k, v in bound.items() if k in remaining}
    out.param_order = tuple(k for k in getattr(plan, "param_order", ())
                            if k in remaining)
    return out, residual


def _param_value(v: Any) -> Any:
    """Python scalar for scalar bindings (torch then promotes it the way
    JAX promotes the reference's bound scalar); arrays become tensors."""
    arr = to_numpy(v)
    return arr.item() if arr.ndim == 0 else torch.as_tensor(arr)


def resolve_params(plan: Plan, params: Any) -> Dict[str, Any]:
    """Normalize a ``params`` argument (positional sequence or name->value
    mapping) into the ``__params__`` binding dict, validated against the
    plan's unbound placeholders.  Positional sequences follow the parse
    order recorded by the SQL frontend (``plan.param_order``)."""
    names = plan_params(plan)
    if params is None:
        params = {}
    if not isinstance(params, dict):
        order = getattr(plan, "param_order", None)
        if order is None:
            raise ValueError(
                "positional params need a plan with recorded parameter "
                "order (parse_query output); pass a {name: value} dict")
        if len(params) != len(order):
            raise ValueError(
                f"expected {len(order)} parameter(s) "
                f"({', '.join(order)}), got {len(params)}")
        params = dict(zip(order, params))
    missing = sorted(names - set(params))
    if missing:
        raise ValueError(f"unbound query parameter(s): {', '.join(missing)}")
    return {k: _param_value(v) for k, v in params.items() if k in names}


def execute(plan: Plan, catalog, config: Optional[ExecutionConfig] = None,
            tables: Optional[Dict[str, Table]] = None,
            params: Any = None) -> Any:
    """Execute ``plan`` against catalog tables (or ``tables`` override), on
    the device those tables live on.

    ``params`` binds query parameters (``?`` / ``:name`` placeholders from
    the SQL frontend): a sequence for positional, a mapping for named."""
    needed = [n.attrs["table"] for n in plan.nodes.values() if n.op == "scan"]
    tabs = dict(tables or {})
    for name in needed:
        if name not in tabs:
            tabs[name] = catalog.get_table(name)
    if params is not None or plan_params(plan):
        bound = resolve_params(plan, params)
        plan, bound = bind_structural_params(plan, bound)
        tabs["__params__"] = bound
    return compile_plan(plan, catalog, config)(tabs)
