"""The port's hash-repartition shuffle exchange (``repro_torch.serve.
exchange`` + ``ShardedExecutor.execute_exchange``): *any* equi-join
shards.  Every case of ``tests/test_exchange.py``, run on the port and,
through the same calls on the same seeded numpy inputs, on the JAX
package: the port's answers equal the JAX service's (built with
``jit=False``) bitwise — or on the validity mask and the valid rows
where the reference compares a join that way — and ``ServiceStats`` and
``shard_info()`` equal field by field.  The shuffle planner
(``hash_buckets``, ``choose_bucket_count``, ``plan_exchange``) is held to
the reference's outputs under hypothesis over sizes, bucket counts and
key dtypes (``-0.0``, NaN and ±inf included); the port's executor is also
driven over four CPU devices, whose answers equal one device's bitwise.

Four layers:

1. **Shuffle-planner units** — determinism, dtype folding, bucket-count
   doubling, row conservation, skew, zero padding (numpy and tensors).
2. **Service integration** — a non-co-partitioned equi-join routes
   through the exchange, matches whole-table execution, repeats warm
   with zero compiles, and is independent of bucket-count knobs and of
   the device count.
3. **Cost gate** — with the gate on, tiny tables fall back to whole-table
   execution; ``shard_exchange=False`` disables the path outright.
4. **Bit-exactness property** (hypothesis + seeded twin).
"""

import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.serve.exchange import (choose_bucket_count, hash_buckets,
                                        plan_exchange, take_pad)

pytestmark = pytest.mark.tier1

AGG_FNS = ["sum", "count", "avg", "min", "max"]
CPU4 = [torch.device("cpu")] * 4


# ---------------------------------------------------------------------------
# Both packages behind one namespace
# ---------------------------------------------------------------------------

def _ns(pkg: str, jit: bool = False):
    if pkg == "jax":
        from repro.core import ExecutionConfig, ModelStore
        from repro.core.ir import Plan
        from repro.relational.expr import col
        from repro.relational.table import Table
        from repro.serve import PredictionService
        store_kw, mask = {}, (lambda v: np.asarray(v, bool))
    else:
        from repro_torch.core import ExecutionConfig, ModelStore
        from repro_torch.core.ir import Plan
        from repro_torch.relational.expr import col
        from repro_torch.relational.table import Table
        from repro_torch.serve import PredictionService
        store_kw = {"device": "cpu"}
        mask = (lambda v: torch.as_tensor(np.asarray(v, bool)))
    return types.SimpleNamespace(
        pkg=pkg, jit=jit, ExecutionConfig=ExecutionConfig,
        ModelStore=lambda: ModelStore(**store_kw), Plan=Plan, col=col,
        Table=Table, PredictionService=PredictionService, mask=mask)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _table(ns, **cols):
    valid = cols.pop("valid", None)
    t = ns.Table.from_pydict({k: np.asarray(v) for k, v in cols.items()})
    if valid is not None:
        t = t.with_valid(ns.mask(valid))
    return t


def _xc_store(ns, n_pids=12, n_rows=60, fact_bounds=(4, 8), seed=0,
              fact_valid=None, dim_valid=None, fact_pids=None):
    """Fact ``visits`` + dim ``patients``, both range-partitioned on
    ``pid`` but with *misaligned* bounds (dim gets one extra partition),
    so ``compatible_partitioning`` is False and the only way to shard the
    join is the hash-repartition exchange."""
    rng = np.random.RandomState(seed)
    if fact_pids is None:
        fact_pids = rng.randint(0, n_pids, n_rows)
    fact_pids = np.sort(np.asarray(fact_pids, np.int32))
    visits = _table(ns, pid=fact_pids,
                    amount=rng.randint(-4, 5, len(fact_pids))
                    .astype(np.float32),
                    valid=fact_valid)
    patients = _table(ns, pid=np.arange(n_pids, dtype=np.int32),
                      region=(np.arange(n_pids) % 3).astype(np.int32),
                      weight=rng.randint(0, 4, n_pids).astype(np.float32),
                      valid=dim_valid)
    dim_bounds = [b + 1 for b in fact_bounds] + [max(fact_bounds) + 2]
    store = ns.ModelStore()
    store.register_table("visits", visits, partition_by="pid",
                         partition_bounds=list(fact_bounds))
    store.register_table("patients", patients, partition_by="pid",
                         partition_bounds=dim_bounds)
    return store


def _join_plan(ns, filter_pred=None):
    plan = ns.Plan()
    v = plan.emit("scan", "RA", [], "table", table="visits")
    if filter_pred is not None:
        v = plan.emit("filter", "RA", [v], "table",
                      predicate=filter_pred(ns.col))
    p = plan.emit("scan", "RA", [], "table", table="patients")
    plan.output = plan.emit("join", "RA", [v, p], "table", on="pid",
                            how="inner")
    return plan


def _join_agg_plan(ns, aggs=None, key="region", num_groups=3,
                   filter_pred=None):
    plan = _join_plan(ns, filter_pred)
    aggs = aggs if aggs is not None else {
        "total": ("sum", "amount"), "n": ("count", None),
        "avg_a": ("avg", "amount"), "lo": ("min", "amount"),
        "hi": ("max", "amount")}
    plan.output = plan.emit("group_agg", "RA", [plan.output], "table",
                            key=key, aggs=aggs, num_groups=num_groups)
    return plan


def _base(ns, store):
    return ns.PredictionService(store, jit=ns.jit)


def _sharded(ns, store, **knobs):
    knobs.setdefault("shard_min_bucket_rows", 4)
    knobs.setdefault("shard_morsel_rows", 16)
    knobs.setdefault("shard_exchange_cost_gate", False)
    if ns.pkg == "jax":
        knobs.pop("shard_devices", None)      # one CPU device there
    return ns.PredictionService(store, jit=ns.jit,
                                execution_config=ns.ExecutionConfig(
                                    sharded=True, **knobs))


def _assert_tables_equal(got, want):
    assert got.capacity == want.capacity
    assert (_host(got.valid) == _host(want.valid)).all()
    assert set(got.columns) == set(want.columns)
    for k in want.columns:
        g, w = _host(got.columns[k]), _host(want.columns[k])
        assert (g == w).all(), k


def _assert_same_valid_rows(got, want):
    vg, vw = _host(got.valid), _host(want.valid)
    assert set(got.columns) == set(want.columns)
    for k in want.columns:
        g = _host(got.columns[k])[vg]
        w = _host(want.columns[k])[vw]
        assert g.shape == w.shape and (g == w).all(), k


def _differential(body, jit=False):
    """Run ``body(ns)`` against the JAX package and the port.  ``body``
    returns ``(outputs, services)``: ``outputs`` a list of
    ``(value, "bits" | "valid")``.  The port's outputs must equal the JAX
    package's (bitwise, or on the mask and the valid rows; answers are
    compared when both run unjitted), and every service's
    ``ServiceStats`` and ``shard_info()`` field by field."""
    results = {}
    for pkg in ("jax", "torch"):
        outs, svcs = body(_ns(pkg, jit))
        results[pkg] = (outs, [asdict(s.stats) for s in svcs],
                        [s.shard_info() for s in svcs])
        for s in svcs:
            s.close()
    (jouts, jstats, jinfo), (touts, tstats, tinfo) = \
        results["jax"], results["torch"]
    assert tstats == jstats
    assert tinfo == jinfo
    if not jit:
        assert len(touts) == len(jouts)
        for (jv, how), (tv, _) in zip(jouts, touts):
            if how == "bits":
                _assert_tables_equal(tv, jv)
                for k in jv.columns:
                    assert _host(tv.columns[k]).dtype \
                        == _host(jv.columns[k]).dtype, k
            else:
                assert (_host(tv.valid) == _host(jv.valid)).all()
                _assert_same_valid_rows(tv, jv)


# ---------------------------------------------------------------------------
# 1. Shuffle-planner units
# ---------------------------------------------------------------------------

def test_hash_buckets_deterministic_and_covering():
    keys = np.arange(100, dtype=np.int64)
    b = hash_buckets(keys, 8)
    assert b.dtype == np.int64
    assert b.min() >= 0 and b.max() < 8
    assert set(b.tolist()) == set(range(8))      # splitmix64 spreads
    assert (hash_buckets(keys, 8) == b).all()    # pure value hashing
    # a tensor key column hashes like its numpy twin
    assert (hash_buckets(torch.as_tensor(keys), 8) == b).all()


def test_hash_buckets_key_dtypes_agree():
    # equal-comparing keys must share a bucket whatever their container:
    # -0.0 == +0.0, f32 widens exactly to f64, ints hash their value
    assert (hash_buckets(np.asarray([-0.0]), 4)
            == hash_buckets(np.asarray([0.0]), 4)).all()
    f32 = hash_buckets(np.arange(32, dtype=np.float32), 16)
    f64 = hash_buckets(np.arange(32, dtype=np.float64), 16)
    assert (f32 == f64).all()
    b = hash_buckets(np.asarray([True, False, True]), 4)
    assert (b[0] == b[2]) and b.min() >= 0 and b.max() < 4


def test_choose_bucket_count_doubles_past_morsel_cap():
    assert choose_bucket_count(100, 4, morsel_rows=64) == 4
    assert choose_bucket_count(1000, 4, morsel_rows=64) == 16
    assert choose_bucket_count(0, 0, morsel_rows=64) == 1
    assert choose_bucket_count(10, 8, morsel_rows=64) == 8


def test_plan_exchange_conserves_rows_and_aligns_sides():
    rng = np.random.RandomState(3)
    a_keys = rng.randint(0, 20, 100).astype(np.int64)
    s_keys = np.arange(20, dtype=np.int64)
    pl = plan_exchange(a_keys, s_keys, 8, min_bucket_rows=4)
    # every row lands in exactly one bucket, ascending within each
    cat = np.concatenate([i for i in pl.anchor_index])
    assert sorted(cat.tolist()) == list(range(100))
    for idx in pl.anchor_index:
        assert (np.diff(idx) > 0).all() if len(idx) > 1 else True
    # same key value -> same bucket on both sides
    ab = hash_buckets(a_keys, 8)
    sb = hash_buckets(s_keys, 8)
    assert (sb[a_keys] == ab).all()
    # pow-2 capacities cover the largest bucket
    assert pl.anchor_rows >= max(len(i) for i in pl.anchor_index)
    assert pl.anchor_rows & (pl.anchor_rows - 1) == 0
    assert pl.total_rows == 100


def test_plan_exchange_skew_all_keys_one_bucket():
    keys = np.full(40, 7, dtype=np.int64)
    pl = plan_exchange(keys, keys[:10], 8, min_bucket_rows=4)
    assert len(pl.active_buckets) == 1
    (b,) = pl.active_buckets
    assert len(pl.anchor_index[b]) == 40 and len(pl.side_index[b]) == 10
    assert pl.anchor_rows >= 40
    assert pl.n_waves(8) == 1                    # one device does it all
    assert pl.bytes_moved(8, 8) == 50 * 8


def test_take_pad_zero_pads_to_capacity():
    arr = torch.arange(10, dtype=torch.float32)
    out = take_pad(arr, np.asarray([3, 5, 7]), 8)
    assert out.shape == (8,)
    assert out[:3].tolist() == [3, 5, 7] and (out[3:] == 0).all()
    empty = take_pad(arr, np.asarray([], np.int64), 4)
    assert empty.shape == (4,) and (empty == 0).all()
    # a validity mask pads with False; an index tensor works alike
    m = take_pad(torch.ones(10, dtype=torch.bool),
                 torch.as_tensor([1, 2]), 4)
    assert m.tolist() == [True, True, False, False]
    # the same rows as the reference's host gather
    from repro.serve.exchange import take_pad as ref_take_pad
    idx = np.asarray([9, 0, 4, 4])
    np.testing.assert_array_equal(
        take_pad(arr, idx, 6).numpy(),
        ref_take_pad(arr.numpy(), idx, 6))


# -- the planner against the reference's, on the same inputs ---------------

_KEY_DTYPES = ["int32", "int64", "float32", "float64", "bool"]
_SPECIALS = [0.0, -0.0, np.nan, np.inf, -np.inf]


def _keys(dtype, values, specials):
    arr = np.asarray(values, np.int64)
    if dtype == "bool":
        return (arr % 2).astype(np.bool_)
    out = arr.astype(dtype)
    if dtype.startswith("float") and specials:
        out = np.concatenate([out, np.asarray(specials, dtype)])
    return out


def test_planner_matches_reference_property():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from repro.serve import exchange as ref

    @settings(max_examples=60, deadline=None)
    @given(dtype=st.sampled_from(_KEY_DTYPES),
           a_vals=st.lists(st.integers(-2**31, 2**31 - 1), max_size=40),
           s_vals=st.lists(st.integers(-50, 50), max_size=20),
           specials=st.lists(st.sampled_from(_SPECIALS), max_size=5),
           n_buckets=st.integers(0, 17), n_devices=st.integers(0, 9),
           morsel_rows=st.integers(1, 64),
           min_bucket_rows=st.integers(1, 16))
    def check(dtype, a_vals, s_vals, specials, n_buckets, n_devices,
              morsel_rows, min_bucket_rows):
        a = _keys(dtype, a_vals, specials)
        s = _keys(dtype, s_vals, specials[::-1])
        np.testing.assert_array_equal(hash_buckets(a, n_buckets),
                                      ref.hash_buckets(a, n_buckets))
        # the port hashes a tensor column like the reference its array
        np.testing.assert_array_equal(
            hash_buckets(torch.as_tensor(a), n_buckets),
            ref.hash_buckets(a, n_buckets))
        total = len(a) * morsel_rows
        assert choose_bucket_count(total, n_devices, morsel_rows) \
            == ref.choose_bucket_count(total, n_devices, morsel_rows)
        got = plan_exchange(a, s, n_buckets, min_bucket_rows)
        want = ref.plan_exchange(a, s, n_buckets, min_bucket_rows)
        assert (got.n_buckets, got.anchor_rows, got.side_rows,
                got.total_rows) == (want.n_buckets, want.anchor_rows,
                                    want.side_rows, want.total_rows)
        for g, w in zip(got.anchor_index + got.side_index,
                        want.anchor_index + want.side_index):
            np.testing.assert_array_equal(g, w)
        assert got.active_buckets == want.active_buckets
        assert got.describe() == want.describe()
        for d in (1, 3, 8):
            assert got.n_waves(d) == want.n_waves(d)
        assert got.bytes_moved(9, 13) == want.bytes_moved(9, 13)

    check()


# ---------------------------------------------------------------------------
# 2. Service integration
# ---------------------------------------------------------------------------

def test_exchange_join_valid_rows_exact():
    def body(ns):
        store = _xc_store(ns, n_pids=12, n_rows=60)
        base = _base(ns, store)
        svc = _sharded(ns, store)
        plan = _join_plan(ns)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        # inner join: unmatched left rows carry garbage-but-masked right
        # columns, so equality is on the mask and the valid rows
        assert (_host(got.valid) == _host(want.valid)).all()
        _assert_same_valid_rows(got, want)
        info = svc.shard_info()
        assert info["exchange_executions"] == 1
        assert info["exchange_fallbacks"] == 0
        assert info["exchange_bytes_moved"] > 0
        assert svc.stats.sharded_executions == 1
        return [(got, "valid"), (want, "valid")], [base, svc]

    _differential(body)


def test_exchange_join_agg_bit_exact():
    def body(ns):
        store = _xc_store(ns, n_pids=12, n_rows=80, fact_bounds=(3, 6, 9))
        base = _base(ns, store)
        svc = _sharded(ns, store)
        plan = _join_agg_plan(ns)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        info = svc.shard_info()
        assert info["exchange_executions"] == 1
        assert info["agg_combines"] == 1
        return [(got, "bits"), (want, "bits")], [base, svc]

    _differential(body)


def test_exchange_warm_repeats_compile_nothing():
    def body(ns):
        store = _xc_store(ns)
        svc = _sharded(ns, store)
        plan = _join_agg_plan(ns)
        svc.run(plan.copy())
        before = (svc.stats.cache_misses, svc.stats.shard_compiles,
                  svc.stats.jit_traces)
        for _ in range(3):
            svc.run(plan.copy())
        after = (svc.stats.cache_misses, svc.stats.shard_compiles,
                 svc.stats.jit_traces)
        assert before == after      # bucket capacities are data-determined
        assert svc.shard_info()["exchange_executions"] == 4
        assert svc.stats.jit_traces > 0
        return [], [svc]

    _differential(body, jit=True)


def test_exchange_placement_independent():
    """Different bucket-count knobs (morsel cap drives
    ``choose_bucket_count``) and device counts produce bitwise-identical
    results — the scatter-back contract makes placement unobservable."""
    def body(ns):
        store = _xc_store(ns, n_pids=12, n_rows=80, fact_bounds=(3, 6, 9))
        plan = _join_agg_plan(ns)
        svc_few = _sharded(ns, store, shard_morsel_rows=1 << 16)
        svc_many = _sharded(ns, store, shard_morsel_rows=8)
        got_few = svc_few.run(plan.copy())
        got_many = svc_many.run(plan.copy())
        _assert_tables_equal(got_many, got_few)
        assert svc_few.shard_info()["exchange_executions"] == 1
        assert svc_many.shard_info()["exchange_executions"] == 1
        return [(got_few, "bits"), (got_many, "bits")], [svc_few, svc_many]

    _differential(body)


@pytest.mark.timeout_guard(600)
@pytest.mark.parametrize("agg", [True, False], ids=["join_agg", "join"])
def test_exchange_four_devices_equal_one(agg):
    """The port's executor over four CPU devices (one worker thread each,
    bucket b on device b % 4): answers bitwise equal to one device's."""
    ns = _ns("torch")
    store = _xc_store(ns, n_pids=12, n_rows=80, fact_bounds=(3, 6, 9))
    plan = _join_agg_plan(ns) if agg else _join_plan(ns)
    one = _sharded(ns, store, shard_morsel_rows=8)
    four = _sharded(ns, store, shard_morsel_rows=8, shard_devices=CPU4)
    try:
        want, got = one.run(plan.copy()), four.run(plan.copy())
        _assert_tables_equal(got, want)
        assert four.shard_info()["devices"] == 4
        assert four.stats.exchange_executions == 1
        assert four.stats.shard_waves < one.stats.shard_waves
    finally:
        one.close()
        four.close()


def test_exchange_with_filter_and_null_keys():
    """Invalid (NULL-key) anchor rows ride the shuffle masked and scatter
    back to their original positions; a filter below the join narrows
    validity without breaking key intactness."""
    def body(ns):
        store = _xc_store(
            ns, n_rows=50, fact_valid=[i % 4 != 1 for i in range(50)],
            dim_valid=[i % 5 != 2 for i in range(12)])
        base = _base(ns, store)
        svc = _sharded(ns, store)
        plan = _join_agg_plan(ns, filter_pred=lambda c: c("amount") > -2)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        assert svc.shard_info()["exchange_executions"] == 1
        return [(got, "bits"), (want, "bits")], [base, svc]

    _differential(body)


def _two_agg_plan(ns, exchange: bool):
    plan = ns.Plan()
    v = plan.emit("scan", "RA", [], "table", table="visits")
    if exchange:
        p = plan.emit("scan", "RA", [], "table", table="patients")
        j = plan.emit("join", "RA", [v, p], "table", on="pid", how="inner")
        a1 = plan.emit("group_agg", "RA", [j], "table", key="region",
                       aggs={"total": ("sum", "amount"),
                             "n": ("count", None)}, num_groups=3)
        p2 = plan.emit("scan", "RA", [], "table", table="patients")
        a2 = plan.emit("group_agg", "RA", [p2], "table", key="region",
                       aggs={"w": ("sum", "weight")}, num_groups=3)
        on = "region"
    else:
        a1 = plan.emit("group_agg", "RA", [v], "table", key="pid",
                       aggs={"total": ("sum", "amount")}, num_groups=10)
        p = plan.emit("scan", "RA", [], "table", table="patients")
        a2 = plan.emit("group_agg", "RA", [p], "table", key="pid",
                       aggs={"w": ("sum", "weight")}, num_groups=10)
        on = "pid"
    plan.output = plan.emit("join", "RA", [a1, a2], "table", on=on,
                            how="inner")
    return plan


def test_exchange_multi_agg_stages():
    """Two sibling aggregations — one over the exchange join, one over a
    plain partitioned scan — each split two-phase independently; the
    global stage joins the combined tables."""
    def body(ns):
        store = _xc_store(ns, n_pids=10, n_rows=70)
        plan = _two_agg_plan(ns, exchange=True)
        base = _base(ns, store)
        svc = _sharded(ns, store)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        assert (_host(got.valid) == _host(want.valid)).all()
        _assert_same_valid_rows(got, want)
        assert svc.stats.shard_agg_combines == 2     # one per stage
        assert svc.shard_info()["exchange_executions"] == 1
        assert svc.stats.sharded_executions == 1
        return [(got, "valid"), (want, "valid")], [base, svc]

    _differential(body)


def test_multi_agg_two_phase_without_exchange():
    """Join of two aggregation outputs: both aggs split two-phase even
    though the joining happens in the global stage."""
    def body(ns):
        store = _xc_store(ns, n_pids=10, n_rows=70)
        plan = _two_agg_plan(ns, exchange=False)
        base = _base(ns, store)
        svc = _sharded(ns, store)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        assert (_host(got.valid) == _host(want.valid)).all()
        _assert_same_valid_rows(got, want)
        assert svc.stats.shard_agg_combines == 2
        assert svc.stats.sharded_executions == 1
        return [(got, "valid"), (want, "valid")], [base, svc]

    _differential(body)


# ---------------------------------------------------------------------------
# 3. Cost gate and kill switch
# ---------------------------------------------------------------------------

def test_cost_gate_falls_back_on_tiny_tables():
    def body(ns):
        store = _xc_store(ns, n_pids=12, n_rows=60)
        base = _base(ns, store)
        svc = _sharded(ns, store, shard_exchange_cost_gate=True)
        plan = _join_agg_plan(ns)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        info = svc.shard_info()
        assert info["exchange_fallbacks"] >= 1       # gate: not worth it
        assert info["exchange_executions"] == 0
        assert svc.stats.sharded_executions == 0     # whole-table
        return [(got, "bits"), (want, "bits")], [base, svc]

    _differential(body)


def test_shard_exchange_off_is_whole_table():
    def body(ns):
        store = _xc_store(ns)
        base = _base(ns, store)
        svc = _sharded(ns, store, shard_exchange=False)
        plan = _join_agg_plan(ns)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        info = svc.shard_info()
        assert info["exchange_executions"] == 0
        assert svc.stats.sharded_executions == 0
        return [(got, "bits"), (want, "bits")], [base, svc]

    _differential(body)


# ---------------------------------------------------------------------------
# 4. Bit-exactness property: exchange == whole-table over random shapes
# ---------------------------------------------------------------------------

def _check_exchange_bit_exact(n_pids, fact_pids, fact_valid, dim_valid,
                              fact_bounds, agg_fns, seed=0):
    aggs = {f"{fn}_{i}": (fn, "amount") for i, fn in enumerate(agg_fns)}

    def body(ns):
        store = _xc_store(ns, n_pids=n_pids, fact_bounds=fact_bounds,
                          seed=seed, fact_valid=fact_valid,
                          dim_valid=dim_valid, fact_pids=fact_pids)
        plan = _join_agg_plan(ns, aggs=aggs, key="region", num_groups=3)
        base = _base(ns, store)
        svc = _sharded(ns, store, shard_morsel_rows=8)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        assert svc.shard_info()["exchange_executions"] == 1
        return [(got, "bits")], [base, svc]

    _differential(body)


def test_exchange_randomized_sweep():
    """Seeded twin of the hypothesis property below (runs everywhere,
    mirrors the repo convention — change both together)."""
    rng = np.random.RandomState(23)
    for i in range(20):
        n_pids = int(rng.randint(1, 13))
        n_rows = int(rng.randint(1, 40))
        n_bounds = int(rng.randint(1, 5))
        bounds = sorted(int(b) for b in rng.randint(0, n_pids + 1,
                                                    n_bounds))
        if i % 4 == 0:          # key skew: every row in one hash bucket
            fact_pids = np.full(n_rows, rng.randint(0, n_pids))
        else:
            fact_pids = rng.randint(0, n_pids, n_rows)
        _check_exchange_bit_exact(
            n_pids=n_pids,
            fact_pids=fact_pids,
            fact_valid=rng.rand(n_rows) < rng.choice([0.0, 0.6, 1.0]),
            dim_valid=rng.rand(n_pids) < 0.9,
            fact_bounds=bounds,
            agg_fns=[AGG_FNS[rng.randint(len(AGG_FNS))]
                     for _ in range(rng.randint(1, 4))],
            seed=i)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                # pragma: no cover
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    @given(
        n_pids=st.integers(min_value=1, max_value=12),
        fact=st.lists(st.tuples(st.integers(0, 11),     # pid (clamped)
                                st.booleans()),         # valid
                      min_size=1, max_size=32),
        dim_valid_bits=st.lists(st.booleans(), min_size=12, max_size=12),
        bounds=st.lists(st.integers(0, 12), min_size=1, max_size=4),
        skew=st.booleans(),
        agg_fns=st.lists(st.sampled_from(AGG_FNS), min_size=1,
                         max_size=3),
    )
    @settings(max_examples=30, deadline=None)
    def test_exchange_bit_exact_property(n_pids, fact, dim_valid_bits,
                                         bounds, skew, agg_fns):
        """Hash-repartition exchange == whole-table execution, bitwise,
        across random misaligned partition layouts (empty partitions
        included), row counts, NULL join keys (invalid rows), and key
        skew (every row hashing to one bucket) — in both packages, the
        port's answers and ledgers equal to the JAX package's."""
        pids = [min(p, n_pids - 1) for p, _m in fact]
        if skew:
            pids = [pids[0]] * len(pids)
        _check_exchange_bit_exact(
            n_pids=n_pids,
            fact_pids=pids,
            fact_valid=[m for _p, m in fact],
            dim_valid=dim_valid_bits[:n_pids],
            fact_bounds=sorted(bounds),
            agg_fns=agg_fns)
