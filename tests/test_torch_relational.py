"""The port's relational operators against the JAX package's, on the same
tables (numpy, from a seed), compared with ``assert_tables_equal``
semantics: masks, ints and row order bitwise.

Float columns are bitwise too, except where a float sum runs over a whole
column (a global SUM/AVG, and the combine of global partial states): XLA
and torch reduce a vector in different orders, so those are held at
``rtol=1e-6``.  Grouped sums are bitwise: the port's deterministic
segmented sum adds each group's rows in row order, the order of XLA's CPU
scatter-add.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.relational import expr as jexpr
from repro.relational import ops as jops
from repro.relational.table import Table as JTable
from repro_torch.relational import expr as texpr
from repro_torch.relational import ops as tops
from repro_torch.relational.table import Table as TTable

_INT32_MAX = np.iinfo(np.int32).max


def _tables(seed=0, n=300, valid_frac=0.8, **extra):
    rng = np.random.default_rng(seed)
    data = {
        "k": rng.integers(0, 6, n).astype(np.int32),
        "g": rng.integers(0, 300, n).astype(np.int32),
        "v": (rng.normal(size=n) * 50).astype(np.float32),
        "w": rng.integers(-5, 5, n).astype(np.int32),
        "s": rng.choice(["red", "green", "blue"], n),
        **extra,
    }
    data["v"][::23] = np.nan
    valid = rng.random(n) < valid_frac
    jt = JTable.from_pydict(data).with_valid(jnp.asarray(valid))
    tt = TTable.from_pydict(data).with_valid(torch.from_numpy(valid))
    return jt, tt


def _assert_tables(jt, tt, float_rtol=None):
    assert sorted(tt.columns) == sorted(jt.columns)   # jit sorts pytrees
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    for name in jt.columns:
        want = np.asarray(jt.columns[name])
        got = tt.columns[name].numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert got.shape == want.shape, name
        if float_rtol is not None and want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=float_rtol, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for name in jt.columns:
        assert tt.schema.field(name).dictionary == \
            jt.schema.field(name).dictionary, name


def _exprs(m):
    col, const, case = m.col, m.const, m.CaseWhen
    return {
        "mixed_cmp": (col("k") * 2.5 > col("w")) & (col("v") < 10.0),
        "or_not": (col("k") == 3) | ~(col("w") >= 0),
        "isnan": m.UnaryOp("isnan", col("v")),
        "int_div": col("g") / 7 > col("k"),
        "case": case(((col("k") > 2, const(1)), (col("w") < 0, const(2))),
                     const(0)) == 1,
        "neg_abs": m.UnaryOp("abs", m.UnaryOp("neg", col("w"))) <= 2,
    }


@pytest.mark.parametrize("name", sorted(_exprs(jexpr)))
def test_filter(name):
    jt, tt = _tables(1)
    want = jax.jit(lambda t: jops.filter_(t, _exprs(jexpr)[name]))(jt)
    _assert_tables(want, tops.filter_(tt, _exprs(texpr)[name]))


def _maps(m):
    col, const = m.col, m.const
    return {
        "int_plus": col("w") + 1,
        "int_div": col("g") / 4,
        "float_mix": col("v") * col("k") - 0.5,
        "case_int": m.CaseWhen(((col("k") > 2, const(1)),), const(0)),
        "case_float": m.CaseWhen(((col("w") < 0, const(1.5)),), col("v")),
    }


@pytest.mark.parametrize("name", sorted(_maps(jexpr)))
def test_with_column(name):
    jt, tt = _tables(2)
    want = jax.jit(lambda t: jops.with_column(t, "out", _maps(jexpr)[name]))(jt)
    _assert_tables(want, tops.with_column(tt, "out", _maps(texpr)[name]))


def test_project():
    jt, tt = _tables(3)
    _assert_tables(jops.project(jt, ["v", "k"]), tops.project(tt, ["v", "k"]))


def _join_sides(seed):
    rng = np.random.default_rng(seed)
    lkeys = rng.integers(0, 60, 200).astype(np.int32)
    lkeys[::31] = _INT32_MAX          # collides with the masked sentinel
    left = {"pid": lkeys, "a": rng.normal(size=200).astype(np.float32)}
    rkeys = rng.permutation(80)[:50].astype(np.int32)
    rkeys[:3] = _INT32_MAX            # duplicate sentinel keys
    right = {"pid": rkeys, "b": rng.integers(0, 9, 50).astype(np.int32),
             "a": rng.normal(size=50).astype(np.float32)}
    rvalid = rng.random(50) < 0.7
    rvalid[:2] = False                # masked rows tie with sentinel keys
    lvalid = rng.random(200) < 0.9
    out = []
    for T, asarray in ((JTable, jnp.asarray), (TTable, torch.from_numpy)):
        out.append((T.from_pydict(left).with_valid(asarray(lvalid)),
                    T.from_pydict(right).with_valid(asarray(rvalid))))
    return out


@pytest.mark.parametrize("how", ["inner", "left_mark"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_unique(seed, how):
    (jl, jr), (tl, tr) = _join_sides(seed)
    want = jax.jit(lambda a, b: jops.join_unique(a, b, "pid", how=how))(jl, jr)
    _assert_tables(want, tops.join_unique(tl, tr, "pid", how=how))


_AGGS = {"n": ("count", None), "sv": ("sum", "v"), "mv": ("avg", "v"),
         "lo": ("min", "v"), "hi": ("max", "w"), "sw": ("sum", "w")}


@pytest.mark.parametrize("key,num_groups", [("k", 6), ("s", None),
                                            ("g", None), ("w", 12)])
def test_group_aggregate_keyed_bitwise(key, num_groups):
    jt, tt = _tables(4)
    aggs = {k: v for k, v in _AGGS.items()}
    want = jax.jit(lambda t: jops.group_aggregate(t, key, aggs,
                                                  num_groups))(jt)
    _assert_tables(want, tops.group_aggregate(tt, key, aggs, num_groups))


def test_group_aggregate_global():
    jt, tt = _tables(5)
    clean = {"n": ("count", None), "sw": ("sum", "w"), "mw": ("avg", "w"),
             "lo": ("min", "w"), "hi": ("max", "v")}
    want = jax.jit(lambda t: jops.group_aggregate(t, None, clean))(jt)
    _assert_tables(want, tops.group_aggregate(tt, None, clean),
                   float_rtol=1e-6)
    fsum = {"sv": ("sum", "k"), "mv": ("avg", "v")}
    jt2 = jops.filter_(jt, ~jexpr.UnaryOp("isnan", jexpr.col("v")))
    tt2 = tops.filter_(tt, ~texpr.UnaryOp("isnan", texpr.col("v")))
    want = jax.jit(lambda t: jops.group_aggregate(t, None, fsum))(jt2)
    _assert_tables(want, tops.group_aggregate(tt2, None, fsum),
                   float_rtol=1e-6)


def _morsels(table, n_parts):
    bounds = np.linspace(0, table.capacity, n_parts + 1).astype(int)
    return [table.row_slice(int(a), int(b))
            for a, b in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("key", ["k", None])
def test_partial_and_combine(key):
    jt, tt = _tables(6)
    jt = jops.filter_(jt, ~jexpr.UnaryOp("isnan", jexpr.col("v")))
    tt = tops.filter_(tt, ~texpr.UnaryOp("isnan", texpr.col("v")))
    aggs = {"n": ("count", None), "sv": ("sum", "v"), "mv": ("mean", "v"),
            "lo": ("min", "v"), "hi": ("max", "v")}
    ng = 6 if key else None
    jparts = [jax.jit(lambda t: jops.partial_aggregate(t, key, aggs, ng))(m)
              for m in _morsels(jt, 3)]
    tparts = [tops.partial_aggregate(m, key, aggs, ng)
              for m in _morsels(tt, 3)]
    rtol = 1e-6 if key is None else None
    for jp, tp in zip(jparts, tparts):
        _assert_tables(jp, tp, float_rtol=rtol)
    _assert_tables(jops.combine_partials(jparts, key, aggs),
                   tops.combine_partials(tparts, key, aggs), float_rtol=rtol)
    _assert_tables(jops.merge_partial_states(jparts, key, aggs),
                   tops.merge_partial_states(tparts, key, aggs),
                   float_rtol=rtol)


def test_partial_aggregate_empty_morsel():
    jt, tt = _tables(7)
    aggs = {"n": ("count", None), "lo": ("min", "v"), "sw": ("sum", "w")}
    _assert_tables(jops.partial_aggregate(jt.row_slice(0, 0), None, aggs),
                   tops.partial_aggregate(tt.row_slice(0, 0), None, aggs))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("key", ["k", "w", "v"])
def test_order_by_with_ties(key, descending):
    jt, tt = _tables(8)
    want = jax.jit(lambda t: jops.order_by(t, key, descending))(jt)
    _assert_tables(want, tops.order_by(tt, key, descending))


@pytest.mark.parametrize("n", [0, 1, 17, 1000])
def test_limit(n):
    jt, tt = _tables(9)
    want = jax.jit(lambda t: jops.limit(t, n))(jt)
    _assert_tables(want, tops.limit(tt, n))


def test_union_all():
    (ja, ta), (jb, tb) = _tables(10), _tables(11)
    _assert_tables(jops.union_all(ja, jb), tops.union_all(ta, tb))


def test_from_pydict_dtypes_and_roundtrip():
    data = {"i": np.arange(5, dtype=np.int64), "f": np.linspace(0, 1, 5),
            "b": np.array([True, False, True, True, False]),
            "s": np.array(["x", "y", "x", "z", "y"])}
    jt, tt = JTable.from_pydict(data), TTable.from_pydict(data)
    _assert_tables(jt, tt)
    assert tt.to_pydict() == jt.to_pydict()
    np.testing.assert_array_equal(tt.to_numpy(["i", "f"]),
                                  jt.to_numpy(["i", "f"]))


def test_from_arrays_matches():
    rng = np.random.default_rng(12)
    cols = {"a": rng.integers(0, 9, 20).astype(np.int32),
            "b": rng.normal(size=20).astype(np.float32)}
    valid = rng.random(20) < 0.5
    _assert_tables(JTable.from_arrays(cols, jnp.asarray(valid)),
                   TTable.from_arrays(cols, torch.from_numpy(valid)))


def test_synthetic_data_same_seed_same_tables():
    from repro.data import synthetic as jdata
    from repro_torch.data import synthetic as tdata
    for name, jt in jdata.hospital_tables(500, seed=3).items():
        _assert_tables(jt, tdata.hospital_tables(500, seed=3)[name])
    for fn in ("hospital_features", "flight_features"):
        (jc, jy), (tc, ty) = getattr(jdata, fn)(400), getattr(tdata, fn)(400)
        np.testing.assert_array_equal(ty, jy)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            np.testing.assert_array_equal(tc[k], jc[k])
