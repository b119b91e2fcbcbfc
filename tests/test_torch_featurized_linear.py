"""The featurized-linear fusion on the CPU: codegen's closure runs a
``featurize -> matmul_bias`` pair as one call of
``kernels/featurized_linear`` (here its plain version), from the raw input
columns, with no feature matrix.

- Through ``compile_plan``, the fused plan's logits (the captured
  ``matmul_bias`` value) and its ``PREDICT_PROBA`` column are **bitwise**
  those of the unfused plan (the featurizers' matrix and the row-wise
  fold, ``ml.linear.rowwise_matmul``), signed zeros included: codes outside
  the kept categories, negative codes, kept sets with gaps, int32 and bool
  code columns, int and float scaled columns, zero weights, 1 and odd row
  counts, and chunks against the whole table.
- Plans the kernel does not take keep the unfused path: a two-column
  ``matmul_bias``, a featurize node with two consumers, a captured or
  output featurize node, an imputer or a bucketizer, float categories,
  a non-finite weight, and input columns whose dtype the catalog's schema
  does not show as one the kernel takes (int64 or float codes, a float64
  scaled column, a column a ``map`` computes, a table outside the
  catalog).  A column of another dtype at run time raises.
- The ``op.matmul_bias`` span names the kernel only when fused; the
  ``meta`` route returns [n, 1] and reports its work.
- A flights query through the optimizer is fused and stays within
  ``rtol=atol=1e-6`` of the JAX package (the repo's linear-inference
  tolerance).

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compile_plan
from repro_torch.core.ir import Category, Plan
from repro_torch.kernels.featurized_linear import ops as fl_ops
from repro_torch.ml import (Bucketizer, Imputer, OneHotEncoder,
                            StandardScaler)
from repro_torch.relational.expr import col, const
from repro_torch.relational.table import ColumnSchema, Schema, Table
from repro_torch.serve import ManualClock, Trace

# one-hot categories: negative codes, gaps, a single category
_CATS = {"a": np.array([-3, 0, 2, 7, 11], np.int32),
         "b": np.array([1, 2, 3], np.int32),
         "c": np.array([4], np.int32)}


def _table(cols, valid=None):
    n = next(iter(cols.values())).shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool,
                           device=next(iter(cols.values())).device)
    return Table(cols, valid, Schema(tuple(ColumnSchema(k, v.dtype)
                                           for k, v in cols.items())))


def _columns(n, seed, code_dtype):
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(-6, 14, n), "b": rng.integers(0, 5, n),
            "c": rng.integers(3, 6, n),
            "x": rng.normal(3.0, 2.0, n).astype(np.float32),
            "k": rng.integers(-50, 50, n).astype(np.int32)}
    for c in "abc":
        if code_dtype == "float32":     # whole numbers, halves, NaN, inf
            v = cols[c].astype(np.float32)
            v[rng.random(n) < 0.2] += 0.5
            v[rng.random(n) < 0.05] = np.nan
            v[rng.random(n) < 0.05] = np.inf
            cols[c] = v
        elif code_dtype == "bool":
            cols[c] = cols[c] % 2 == 0
        else:
            cols[c] = cols[c].astype(code_dtype)
    t = {k: torch.as_tensor(v) for k, v in cols.items()}
    return _table(t, torch.as_tensor(rng.random(n) < 0.8))


class _Catalog:
    """What ``compile_plan`` reads of a catalog: the schema of table
    ``t``."""

    def __init__(self, table):
        self.table = table

    def get_table(self, name):
        if name != "t":
            raise KeyError(name)
        return self.table


def _featurizers(code_dtype):
    enc = OneHotEncoder(["a", "b", "c"])
    enc.categories = {k: (np.array([0, 1], np.int32) if code_dtype == "bool"
                          else v) for k, v in _CATS.items()}
    sc = StandardScaler(["x", "k"])
    sc.mean = np.array([3.1, -0.5], np.float32)
    sc.std = np.array([1.9, 28.0], np.float32)
    return [enc, sc]


def _weights(featurizers, seed, weights):
    width = sum(len(v) for v in featurizers[0].categories.values()) + 2
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 1.0, (width, 1)).astype(np.float32)
    if weights == "zeros":          # a zero scaler term and a zero category
        w[-1], w[1] = 0.0, -0.0
    elif weights == "negative":     # every block's weights below zero
        w = -np.abs(w)
    return w


def _plan(featurizers, w, bias=(0.25,), out_feat=False):
    p = Plan()
    scan = p.emit("scan", Category.RA, [], "table", table="t")
    feat = p.emit("featurize", Category.MLD, [scan], "matrix",
                  featurizers=featurizers)
    mm = p.emit("matmul_bias", Category.LA, [feat], "matrix",
                weights=w, bias=np.asarray(bias, np.float32))
    sel = p.emit("select_column", Category.LA, [mm], "matrix", index=0)
    p.output = feat if out_feat else p.emit("sigmoid", Category.LA, [sel],
                                            "matrix")
    return p, feat, mm


def _run(plan, table, capture, catalog=True):
    """(output, captured value, whether op.matmul_bias named the kernel);
    the catalog holds ``table`` unless ``catalog`` is False"""
    tr = Trace(ManualClock())
    fn = compile_plan(plan, _Catalog(table) if catalog else None,
                      capture=capture)
    out, got = fn({"t": table}, trace=tr)
    kernels = {s.attrs.get("kernel") for s in tr.spans()
               if s.name == "op.matmul_bias"}
    return out, got, kernels == {"featurized_linear"}


def _unfused(plan, table, capture, monkeypatch, catalog=True):
    with monkeypatch.context() as m:
        m.setattr(fl_ops, "fusable", lambda *a: False)
        out, got, fused = _run(plan, table, capture, catalog)
    assert not fused
    return out, got


def _same_bits(a, b):
    """Equal to the bit: float32 compared as int32, so -0 differs from +0
    (``torch.equal`` takes them for one value)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 7, 1001, 4097])
@pytest.mark.parametrize("code_dtype", ["int32", "bool"])
@pytest.mark.parametrize("weights,bias", [("random", 0.25),
                                          ("zeros", -1.5),
                                          ("negative", -0.0)])
def test_fused_pair_is_bitwise_the_unfused_fold(n, code_dtype, weights, bias,
                                                monkeypatch):
    feats = _featurizers(code_dtype)
    w = _weights(feats, n, weights)
    plan, _, mm = _plan(feats, w, (bias,))
    table = _columns(n, n + 1, code_dtype)
    out, logits, fused = _run(plan, table, mm)
    want_out, want_logits = _unfused(plan, table, mm, monkeypatch)
    assert fused and logits.shape == (n, 1)
    _same_bits(logits, want_logits)
    _same_bits(out, want_out)


def test_a_missed_all_negative_block_keeps_the_folds_negative_zero(
        monkeypatch):
    enc = OneHotEncoder(["a"])
    enc.categories = {"a": _CATS["a"]}
    w = -np.ones((5, 1), np.float32)
    plan, _, mm = _plan([enc], w, (-0.0,))
    table = _table({"a": torch.tensor([100, -3, 5], dtype=torch.int32)})
    _, logits, fused = _run(plan, table, mm)
    _, want = _unfused(plan, table, mm, monkeypatch)
    assert fused
    assert torch.signbit(want[0, 0]) and torch.signbit(logits[0, 0])
    _same_bits(logits, want)


def test_chunks_are_bitwise_the_whole_table():
    feats = _featurizers("int32")
    plan, _, mm = _plan(feats, _weights(feats, 3, "random"))
    table = _columns(1001, 5, "int32")
    fn = compile_plan(plan, _Catalog(table), capture=mm)
    whole = fn({"t": table})[1]
    parts = [fn({"t": _table({k: v[a:b] for k, v in table.columns.items()},
                             table.valid[a:b])})[1]
             for a, b in [(0, 1), (1, 300), (300, 1001)]]
    _same_bits(torch.cat(parts), whole)


def _two_consumers(feats, w):
    p = Plan()
    scan = p.emit("scan", Category.RA, [], "table", table="t")
    feat = p.emit("featurize", Category.MLD, [scan], "matrix",
                  featurizers=feats)
    heads = [p.emit("matmul_bias", Category.LA, [feat], "matrix",
                    weights=w * s, bias=np.float32([0.5]))
             for s in (1, 2)]
    cols = [p.emit("select_column", Category.LA, [h], "matrix", index=0)
            for h in heads]
    t = p.emit("attach_column", Category.RA, [scan, cols[0]], "table",
               name="s1")
    p.output = p.emit("attach_column", Category.RA, [t, cols[1]], "table",
                      name="s2")
    return p, feat, heads[0]


def _computed_column(feats, w):
    """The scaled column ``k`` computed by a ``map`` (its dtype is not in
    any schema)."""
    p = Plan()
    scan = p.emit("scan", Category.RA, [], "table", table="t")
    k = p.emit("map", Category.RA, [scan], "table", name="k",
               expr=col("a") + const(1))
    feat = p.emit("featurize", Category.MLD, [k], "matrix",
                  featurizers=feats)
    mm = p.emit("matmul_bias", Category.LA, [feat], "matrix", weights=w,
                bias=np.float32([0.5]))
    sel = p.emit("select_column", Category.LA, [mm], "matrix", index=0)
    p.output = p.emit("sigmoid", Category.LA, [sel], "matrix")
    return p, feat, mm


def _case(name):
    """(plan, captured node, table, whether the catalog holds it)"""
    feats = _featurizers("int32")
    w = _weights(feats, 1, "random")
    table, catalog = _columns(257, 9, "int32"), True
    if name in ("int64_codes", "float_codes"):
        table = _columns(257, 9, "int64" if name == "int64_codes"
                         else "float32")
        plan, feat, mm = _plan(feats, w)
    elif name == "float64_scaled":
        table = _table({**table.columns,
                        "x": table.columns["x"].to(torch.float64)},
                       table.valid)
        plan, feat, mm = _plan(feats, w)
    elif name == "computed_column":
        plan, feat, mm = _computed_column(feats, w)
    elif name == "table_outside_the_catalog":
        plan, feat, mm = _plan(feats, w)
        catalog = False
    elif name == "two_output_columns":
        plan, feat, mm = _plan(feats, np.concatenate([w, -w], 1), (0.5, 1.0))
    elif name == "two_consumers":
        plan, feat, mm = _two_consumers(feats, w)
    elif name == "featurize_captured":
        plan, feat, mm = _plan(feats, w)
        return plan, feat, table, catalog
    elif name == "featurize_output":
        plan, feat, mm = _plan(feats, w, out_feat=True)
    elif name == "imputer":
        im = Imputer(["x"])
        im.fill = np.float32([0.0])
        plan, feat, mm = _plan(feats + [im], np.concatenate([w, w[:1]]))
    elif name == "bucketizer":
        plan, feat, mm = _plan(feats + [Bucketizer("x", [0.0, 3.0])],
                               np.concatenate([w, w[:3]]))
    elif name == "float_categories":
        feats[0].categories["b"] = feats[0].categories["b"].astype(
            np.float32)
        plan, feat, mm = _plan(feats, w)
    elif name == "non_finite_weight":
        w[2] = np.inf
        plan, feat, mm = _plan(feats, w)
    return plan, mm, table, catalog


@pytest.mark.parametrize("name", [
    "two_output_columns", "two_consumers", "featurize_captured",
    "featurize_output", "imputer", "bucketizer", "float_categories",
    "non_finite_weight", "int64_codes", "float_codes", "float64_scaled",
    "computed_column", "table_outside_the_catalog"])
def test_plans_the_kernel_does_not_take_keep_the_unfused_path(name,
                                                              monkeypatch):
    plan, capture, table, catalog = _case(name)
    out, got, fused = _run(plan, table, capture, catalog)
    want_out, want_got = _unfused(plan, table, capture, monkeypatch,
                                  catalog)
    assert not fused
    _same_bits(got, want_got)
    if isinstance(out, Table):
        for k in out.columns:
            assert torch.equal(out.columns[k], want_out.columns[k])
    else:
        _same_bits(out, want_out)


def test_only_a_fused_pair_names_the_kernel_on_its_span():
    feats = _featurizers("int32")
    plan, _, mm = _plan(feats, _weights(feats, 1, "random"))
    table = _columns(64, 1, "int32")
    tr = Trace(ManualClock())
    compile_plan(plan, _Catalog(table))({"t": table}, trace=tr)
    attrs = {s.name: s.attrs for s in tr.spans() if s.name.startswith("op.")}
    assert attrs["op.matmul_bias"]["kernel"] == "featurized_linear"
    assert all("kernel" not in a for k, a in attrs.items()
               if k != "op.matmul_bias")
    plan2, _, _, _ = _case("two_output_columns")
    tr2 = Trace(ManualClock())
    compile_plan(plan2, _Catalog(table))({"t": table}, trace=tr2)
    assert all("kernel" not in s.attrs for s in tr2.spans())


def test_meta_route_returns_the_logits_shape_and_reports_its_work():
    from repro_torch.launch.cost_analysis import CostCounter
    feats = _featurizers("int32")
    plan, _, mm = _plan(feats, _weights(feats, 1, "random"))
    n, meta = 5_819_079, torch.device("meta")
    cols = {c: torch.empty((n,), dtype=torch.int32, device=meta)
            for c in "abck"}
    cols["x"] = torch.empty((n,), dtype=torch.float32, device=meta)
    table = _table(cols, torch.empty((n,), dtype=torch.bool, device=meta))
    before = fl_ops.launches
    with CostCounter() as counter:
        out, logits = compile_plan(plan, _Catalog(table),
                                   capture=mm)({"t": table})
    assert logits.shape == (n, 1) and logits.device.type == "meta"
    assert out.shape == (n,)
    work = counter.cost.kernels["featurized_linear"]
    assert work["calls"] == 1
    assert work["bytes"] == n * (5 * 4 + 4)
    assert fl_ops.launches == before


def test_cpu_tensors_launch_nothing_and_other_devices_raise():
    feats = _featurizers("int32")
    w = _weights(feats, 1, "random")
    op = fl_ops.prepare(feats, w, np.float32([0.5]), "cpu")
    table = _columns(33, 2, "int32")
    before = fl_ops.launches
    assert fl_ops.featurized_linear(op, table.columns).shape == (33, 1)
    assert fl_ops.launches == before
    with pytest.raises(ValueError, match="expected"):
        fl_ops.featurized_linear(op, {**table.columns,
                                      "x": table.columns["x"][:5]})
    for c, dtype in (("a", torch.int64), ("b", torch.float32),
                     ("x", torch.float64)):
        with pytest.raises(TypeError, match=repr(c)):
            fl_ops.featurized_linear(op, {**table.columns,
                                          c: table.columns[c].to(dtype)})


# -- through the optimizer, against the JAX package ---------------------------

_SQL = {"route_risk": "SELECT origin, dest, PREDICT_PROBA(MODEL='delay') "
                      "AS p FROM flights WHERE taxi_out >= 15",
        "hourly_delay": "SELECT dep_hour, AVG(__pred_0_delay) AS p "
                        "FROM flights WHERE PREDICT_PROBA(MODEL='delay') >= 0 "
                        "AND distance >= 800 GROUP BY dep_hour"}


@pytest.fixture(scope="module")
def flights():
    from repro import core as jcore
    from repro import ml as jml
    from repro.data import flight_features as jflights
    from repro.relational.table import Table as JTable
    from repro_torch import core as tcore
    from repro_torch.data import flight_features
    from repro_torch.ml.convert import pipeline_from_state, pipeline_state
    n = 3001
    jcols, jy = jflights(n, seed=4)
    tcols, _ = flight_features(n, seed=4)
    jpipe = jml.Pipeline(
        [jml.OneHotEncoder(["origin", "dest", "carrier", "dow"]),
         jml.StandardScaler(["distance", "taxi_out", "dep_hour"])],
        jml.LogisticRegression(l1=0.01, steps=60),
        jml.PipelineMetadata(name="delay")).fit(jcols, jy)
    jstore, tstore = jcore.ModelStore(), tcore.ModelStore(device="cpu")
    jstore.register_table("flights", JTable.from_pydict(jcols))
    tstore.register_table("flights", Table.from_pydict(tcols))
    jstore.register_model("delay", jpipe)
    tstore.register_model("delay",
                          pipeline_from_state(pipeline_state(jpipe)))
    return jstore, tstore


@pytest.mark.parametrize("query", sorted(_SQL))
def test_flights_queries_fuse_and_match_jax(flights, query, monkeypatch):
    from repro import core as jcore
    from repro_torch import core as tcore
    jstore, tstore = flights
    sql = _SQL[query]
    jplan, _ = jcore.CrossOptimizer(jstore).optimize(
        jcore.parse_query(sql, jstore))
    tplan, _ = tcore.CrossOptimizer(tstore).optimize(
        tcore.parse_query(sql, tstore))
    tables = {"flights": tstore.get_table("flights")}
    tr = Trace(ManualClock())
    got = tcore.compile_plan(tplan, tstore)(tables, trace=tr)
    assert [s.attrs.get("kernel") for s in tr.spans()
            if s.name == "op.matmul_bias"] == ["featurized_linear"]
    with monkeypatch.context() as m:
        m.setattr(fl_ops, "fusable", lambda *a: False)
        unfused = tcore.compile_plan(tplan, tstore)(tables)
    want = jcore.execute(jplan, jstore)
    valid = np.asarray(got.valid)
    assert (valid == np.asarray(want.valid)).all()
    assert torch.equal(got.valid, unfused.valid)
    for k in got.columns:
        _same_bits(got.columns[k], unfused.columns[k])
        np.testing.assert_allclose(np.asarray(got.columns[k])[valid],
                                   np.asarray(want.columns[k])[valid],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
