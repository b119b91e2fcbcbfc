"""Property tests: the port's relational operators against a numpy oracle
(plain compacting SQL-bag semantics), as ``tests/test_relational_properties
.py`` holds the JAX package's, and against the JAX package itself on the
same drawn tables (masks, ints and row order bitwise; float sums within
the oracle's own tolerances)."""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro import relational as jrel
from repro_torch.relational import (Table, col, filter_, group_aggregate,
                                    join_unique, limit, order_by, union_all)

settings.register_profile("torch_rel", max_examples=25, deadline=None)
settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "torch_rel"))


@st.composite
def table_data(draw, min_rows=1, max_rows=40):
    n = draw(st.integers(min_rows, max_rows))
    ints = draw(st.lists(st.integers(-5, 5), min_size=n, max_size=n))
    # no subnormals: XLA's CPU backend flushes them to zero (so a sort
    # ties them with 0.0) and torch keeps them (ROADMAP, queue 3)
    floats = draw(st.lists(
        st.floats(-100, 100, allow_nan=False, allow_subnormal=False,
                  width=32),
        min_size=n, max_size=n))
    cats = draw(st.lists(st.integers(0, 3), min_size=n, max_size=n))
    return {"a": np.asarray(ints, np.int32),
            "x": np.asarray(floats, np.float32),
            "g": np.asarray(cats, np.int32)}


def _same_as_jax(got, want):
    """Port table vs JAX table: validity, ints and order bitwise."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for name in want.columns:
        w = np.asarray(want.columns[name])
        g = got.columns[name].numpy()
        assert g.dtype == w.dtype, name
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=name)


@given(table_data(), st.integers(-5, 5))
def test_filter_matches_numpy(data, threshold):
    out = filter_(Table.from_pydict(data), col("a") > threshold)
    got = out.to_pydict()
    keep = data["a"] > threshold
    assert got["a"] == data["a"][keep].tolist()
    np.testing.assert_array_equal(got["x"], data["x"][keep])
    _same_as_jax(out, jrel.filter_(jrel.Table.from_pydict(data),
                                   jrel.col("a") > threshold))


@given(table_data(), st.integers(-5, 5), st.integers(0, 3))
def test_conjunctive_filter(data, thr_a, thr_g):
    out = filter_(Table.from_pydict(data),
                  (col("a") > thr_a) & (col("g") == thr_g))
    keep = (data["a"] > thr_a) & (data["g"] == thr_g)
    assert out.to_pydict()["a"] == data["a"][keep].tolist()


@given(table_data())
def test_group_aggregate_matches_numpy(data):
    aggs = {"s": ("sum", "x"), "n": ("count", None), "m": ("avg", "x")}
    out = group_aggregate(Table.from_pydict(data), "g", aggs, num_groups=4)
    got = out.to_pydict()
    for i, gval in enumerate(got["g"]):
        mask = data["g"] == gval
        assert mask.sum() == got["n"][i]
        assert np.isclose(got["s"][i], data["x"][mask].sum(), atol=1e-2)
        assert np.isclose(got["m"][i], data["x"][mask].mean(), atol=1e-3)
    want = jrel.group_aggregate(jrel.Table.from_pydict(data), "g", aggs,
                                num_groups=4)
    _same_as_jax(out, want)
    np.testing.assert_array_equal(out.columns["s"].numpy(),
                                  np.asarray(want.columns["s"]))


@given(table_data())
def test_global_aggregate(data):
    out = group_aggregate(Table.from_pydict(data), None,
                          {"mx": ("max", "x"), "mn": ("min", "x"),
                           "n": ("count", None)})
    got = out.to_pydict()
    assert got["n"] == [len(data["x"])]
    assert got["mx"][0] == data["x"].max()
    assert got["mn"][0] == data["x"].min()


@given(table_data(min_rows=2))
def test_order_by_limit(data):
    t = Table.from_pydict(data)
    out = limit(order_by(t, "x", descending=True), 3)
    got = out.to_pydict()["x"]
    ref = sorted(data["x"].tolist(), reverse=True)[:3]
    assert np.allclose(sorted(got, reverse=True), ref, atol=1e-5)
    jt = jrel.Table.from_pydict(data)
    _same_as_jax(out, jrel.limit(jrel.order_by(jt, "x", descending=True), 3))


@given(st.integers(2, 30), st.integers(2, 30), st.integers(0, 100))
def test_join_unique_matches_numpy(n_left, n_right, seed):
    rng = np.random.default_rng(seed)
    rkeys = rng.permutation(50)[:n_right].astype(np.int32)
    lkeys = rng.choice(50, n_left).astype(np.int32)
    ldata = {"k": lkeys, "lv": np.arange(n_left, dtype=np.float32)}
    rdata = {"k": rkeys,
             "rv": rng.normal(size=n_right).astype(np.float32)}
    out = join_unique(Table.from_pydict(ldata), Table.from_pydict(rdata),
                      on="k")
    got = out.to_pydict()
    rmap = {int(k): float(v) for k, v in zip(rkeys, rdata["rv"])}
    exp_keys = [int(k) for k in lkeys if int(k) in rmap]
    assert got["k"] == exp_keys
    assert np.allclose(got["rv"], [rmap[k] for k in exp_keys], atol=1e-5)
    _same_as_jax(out, jrel.join_unique(jrel.Table.from_pydict(ldata),
                                       jrel.Table.from_pydict(rdata), on="k"))


@given(table_data(), table_data())
def test_union_all_counts(d1, d2):
    t = union_all(Table.from_pydict(d1), Table.from_pydict(d2))
    assert int(t.num_valid()) == len(d1["a"]) + len(d2["a"])
    assert t.num_valid().dtype == torch.int32


@given(table_data(), st.integers(-5, 5))
def test_filter_after_union_commutes(data, thr):
    t1 = Table.from_pydict(data)
    t2 = Table.from_pydict(data)
    pred = col("a") > thr
    a = filter_(union_all(t1, t2), pred).to_pydict()
    b = union_all(filter_(t1, pred), filter_(t2, pred)).to_pydict()
    assert a["a"] == b["a"]
