"""Partition-wise sharded joins + two-phase aggregation, on the port.
Every case of ``tests/test_distributed_plans.py`` runs on the port and,
through the same calls on the same seeded numpy inputs, on the JAX
package: partition layouts, rule marks and plan signatures equal the
reference's; the port's answers equal the JAX service's (built with
``jit=False``) bitwise — on the validity mask and the valid rows where
the reference compares a join that way — and ``ServiceStats`` and
``shard_info()`` equal field by field.  Partition-wise joins and
two-phase aggregations over four CPU devices equal one device bitwise.

Five layers:

1. **Key-aware partitioning units** — ``partition_by`` registration and
   the zone-map-based ``compatible_partitioning`` check.
2. **Rule marking units** — ``distributed_plan`` marks co-partitioned
   joins ``partition_wise``, others ``exchange``, and eligible
   aggregations ``two_phase``.
3. **Partial/combine units** — partial states over row pieces fold to
   exactly ``group_aggregate`` over the whole table.
4. **Service integration** — ``ExecutionConfig(sharded=True)`` routes
   distributed-rewritten plans through aligned-morsel execution; warm
   repeats compile nothing; override tables, all-pruned anchors and
   mid-flight re-registrations fall back.
5. **Bit-exactness property** (hypothesis + seeded twin): sharded ==
   unsharded bitwise over random layouts (integer-valued data, so float
   sums are exact); a non-co-partitioned pair falls back.
"""

import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.relational import ops as rel_ops

pytestmark = pytest.mark.tier1

AGG_FNS = ["sum", "count", "avg", "min", "max"]
CPU4 = [torch.device("cpu")] * 4


def _ns(pkg: str, jit: bool = False):
    if pkg == "jax":
        import repro.core as core
        import repro.core.ir as ir
        import repro.core.partition as partition
        import repro.relational.ops as ops
        import repro.relational.table as table
        from repro.relational.expr import col
        from repro.serve import PredictionService
        store_kw, mask = {}, (lambda v: np.asarray(v, bool))
    else:
        import repro_torch.core as core
        import repro_torch.core.ir as ir
        import repro_torch.core.partition as partition
        import repro_torch.relational.ops as ops
        import repro_torch.relational.table as table
        from repro_torch.relational.expr import col
        from repro_torch.serve import PredictionService
        store_kw = {"device": "cpu"}
        mask = (lambda v: torch.as_tensor(np.asarray(v, bool)))
    return types.SimpleNamespace(
        pkg=pkg, jit=jit, core=core, ir=ir, partition=partition, ops=ops,
        Table=table.Table, ColumnSchema=table.ColumnSchema, col=col,
        PredictionService=PredictionService, mask=mask,
        ModelStore=lambda: core.ModelStore(**store_kw))


J, T = _ns("jax"), _ns("torch")


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _table(ns, **cols):
    valid = cols.pop("valid", None)
    t = ns.Table.from_pydict({k: np.asarray(v) for k, v in cols.items()})
    if valid is not None:
        t = t.with_valid(ns.mask(valid))
    return t


def _co_store(ns, n_pids=12, n_rows=60, bounds=(4, 8), seed=0,
              fact_valid=None, dim_valid=None):
    """Fact table ``visits`` + dim table ``patients``, both range-
    partitioned on ``pid`` with the same explicit bounds."""
    rng = np.random.RandomState(seed)
    pids = np.sort(rng.randint(0, n_pids, n_rows)).astype(np.int32)
    visits = _table(ns, pid=pids,
                    amount=rng.randint(-4, 5, n_rows).astype(np.float32),
                    valid=fact_valid)
    patients = _table(ns, pid=np.arange(n_pids, dtype=np.int32),
                      region=(np.arange(n_pids) % 3).astype(np.int32),
                      weight=rng.randint(0, 4, n_pids).astype(np.float32),
                      valid=dim_valid)
    store = ns.ModelStore()
    store.register_table("visits", visits, partition_by="pid",
                         partition_bounds=list(bounds))
    store.register_table("patients", patients, partition_by="pid",
                         partition_bounds=list(bounds))
    return store, visits, patients


def _join_plan(ns, filter_pred=None):
    plan = ns.ir.Plan()
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
    if ns.pkg == "jax":
        knobs.pop("shard_devices", None)      # one CPU device there
    return ns.PredictionService(store, jit=ns.jit,
                                execution_config=ns.core.ExecutionConfig(
                                    sharded=True, **knobs))


def _assert_tables_equal(got, want):
    assert got.capacity == want.capacity
    assert (_host(got.valid) == _host(want.valid)).all()
    assert set(got.columns) == set(want.columns)
    for k in want.columns:
        g, w = _host(got.columns[k]), _host(want.columns[k])
        assert g.dtype == w.dtype, k
        assert (g == w).all(), k


def _assert_same_valid_rows(got, want, close=()):
    vg, vw = _host(got.valid), _host(want.valid)
    assert set(got.columns) == set(want.columns)
    _assert_close_valid_rows(got, want, close)
    for k in want.columns:
        if k in close:
            continue
        g = _host(got.columns[k])[vg]
        w = _host(want.columns[k])[vw]
        assert g.shape == w.shape and (g == w).all(), k


def _optimize(ns, store, plan, **cfg):
    return ns.core.CrossOptimizer(
        store, ns.core.OptimizerConfig(**cfg)).optimize(plan)


def _differential(body, jit=False):
    """``body(ns)`` in both packages, returning ``(outputs, services)``
    with ``outputs`` a list of ``(value, "bits" | ("valid", *close))``:
    the port's outputs equal the JAX package's (when both run unjitted) —
    bitwise, or on the mask and the valid rows with the ``close`` columns
    held within the linear-inference tolerance — and every service's
    ``ServiceStats`` and ``shard_info()`` field by field."""
    res = {}
    for pkg in ("jax", "torch"):
        outs, svcs = body(_ns(pkg, jit))
        res[pkg] = (outs, [asdict(s.stats) for s in svcs],
                    [s.shard_info() for s in svcs])
        for s in svcs:
            s.close()
    (jo, js, ji), (to, ts, ti) = res["jax"], res["torch"]
    assert ts == js and ti == ji
    if not jit:
        assert len(to) == len(jo)
        for (jv, how), (tv, _) in zip(jo, to):
            if how == "bits":
                _assert_tables_equal(tv, jv)
            else:
                assert (_host(tv.valid) == _host(jv.valid)).all()
                _assert_same_valid_rows(tv, jv, close=how[1:])


def _assert_close_valid_rows(got, want, names):
    """Model scores across the two packages: a linear model's dot product
    rounds by its own association order in each, so its column is held
    within ``rtol=atol=1e-6`` (the repo's linear-inference tolerance)."""
    vg, vw = _host(got.valid), _host(want.valid)
    for k in names:
        np.testing.assert_allclose(_host(got.columns[k])[vg],
                                   _host(want.columns[k])[vw],
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _layout(pt):
    return None if pt is None else (pt.partition_by, [
        (p.start, p.stop, p.zone.n_valid) for p in pt.partitions])


def _both(fn):
    want, got = fn(J), fn(T)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# 1. Key-aware partitioning + compatible_partitioning
# ---------------------------------------------------------------------------

def test_partition_by_snaps_duplicate_keys_to_one_partition():
    def fn(ns):
        t = _table(ns, pid=np.asarray([0, 1, 1, 1, 2, 3], np.int32))
        return _layout(ns.partition.PartitionedTable.build(
            t, partition_rows=2, partition_by="pid"))

    by, parts = _both(fn)
    assert by == "pid"
    # the naive cut at row 2 would split the run of 1s; it must extend
    assert [(a, b) for a, b, _ in parts] == [(0, 4), (4, 6)]


def test_partition_by_requires_sorted_keys():
    for ns in (J, T):
        t = _table(ns, pid=np.asarray([3, 1, 2], np.int32))
        PT = ns.partition.PartitionedTable
        with pytest.raises(ValueError, match="not sorted"):
            PT.build(t, partition_rows=2, partition_by="pid")
        with pytest.raises(ValueError, match="not sorted"):
            PT.build_by_bounds(t, "pid", [2])


def test_partition_bounds_tile_with_empty_partitions():
    def fn(ns):
        t = _table(ns, pid=np.asarray([0, 0, 5, 5, 9], np.int32))
        return _layout(ns.partition.PartitionedTable.build_by_bounds(
            t, "pid", [2, 4, 7]))

    _by, parts = _both(fn)
    assert [(a, b) for a, b, _ in parts] == \
        [(0, 2), (2, 2), (2, 4), (4, 5)]        # [2,4) holds no rows
    assert parts[1][2] == 0


def test_register_table_partition_by_validation():
    def fn(ns):
        store = ns.ModelStore()
        t = _table(ns, pid=np.arange(6, dtype=np.int32))
        with pytest.raises(ValueError, match="partition_by requires"):
            store.register_table("t", t, partition_by="pid")
        with pytest.raises(ValueError, match="requires partition_by"):
            store.register_table("t", t, partition_bounds=[2])
        store.register_table("t", t, partition_by="pid", partition_rows=2)
        return _layout(store.get_partitioned("t"))

    assert _both(fn)[0] == "pid"


def test_compatible_partitioning_aligned_and_misaligned():
    def fn(ns):
        cp = ns.partition.compatible_partitioning
        store, *_ = _co_store(ns, bounds=(4, 8))
        a = store.get_partitioned("visits")
        b = store.get_partitioned("patients")
        store2, *_ = _co_store(ns, bounds=(6,))
        t = _table(ns, pid=np.arange(8, dtype=np.int32))
        unkeyed = ns.partition.PartitionedTable.build(t, partition_rows=4)
        return (cp(a, b, "pid"), cp(a, b, "amount"), cp(a, None, "pid"),
                cp(a, store2.get_partitioned("patients"), "pid"),
                cp(a, unkeyed, "pid"))

    # aligned; wrong key; no side; different bounds (ranges overlap
    # across indices); row-count partitioning has no declared key
    assert _both(fn) == (True, False, False, False, False)


def test_compatible_partitioning_conservative_on_nan_keys():
    def fn(ns):
        PT = ns.partition.PartitionedTable
        cp = ns.partition.compatible_partitioning
        vals = np.asarray([0.0, np.nan, 5.0, 9.0], np.float32)
        # NaN sorts "anywhere" for the sortedness check but poisons the
        # zone stats of its partition -> the check proves nothing
        pt = PT.build_by_bounds(_table(ns, pid=vals), "pid", [4.0])
        other = PT.build_by_bounds(
            _table(ns, pid=np.asarray([1.0, 6.0], np.float32)), "pid",
            [4.0])
        return cp(pt, other, "pid"), cp(other, other, "pid")

    assert _both(fn) == (False, True)


def test_compatible_partitioning_ignores_invalid_rows():
    def fn(ns):
        PT = ns.partition.PartitionedTable
        # an all-invalid partition has no key range: it constrains nothing
        t1 = _table(ns, pid=np.asarray([0, 1, 8, 9], np.int32),
                    valid=[1, 1, 0, 0])
        t2 = _table(ns, pid=np.asarray([1, 7], np.int32))
        a = PT.build_by_bounds(t1, "pid", [5])
        b = PT.build_by_bounds(t2, "pid", [5])
        return ns.partition.compatible_partitioning(a, b, "pid")

    assert _both(fn) is True


# ---------------------------------------------------------------------------
# 2. Rule marking
# ---------------------------------------------------------------------------

def _marks(plan):
    return sorted((n.op, tuple(sorted(k for k in n.attrs if k in (
        "partition_wise", "exchange", "two_phase"))))
        for n in plan.nodes.values() if n.op in ("join", "group_agg"))


def test_rule_marks_co_partitioned_join_and_two_phase_agg():
    def fn(ns):
        store, *_ = _co_store(ns)
        opt, report = _optimize(ns, store, _join_agg_plan(ns))
        assert report.fired("distributed_plan")
        assert opt.find("join")[0].attrs.get("partition_wise") is True
        assert opt.find("group_agg")[0].attrs.get("two_phase") is True
        # marks are part of the structural signature: a distributed plan
        # never shares an executable with its whole-table twin
        opt2, _ = _optimize(ns, store, _join_agg_plan(ns),
                            enable_distributed_plan=False)
        assert "partition_wise" not in opt2.find("join")[0].attrs
        assert ns.ir.plan_signature(opt) != ns.ir.plan_signature(opt2)
        return (_marks(opt), ns.ir.plan_signature(opt),
                ns.ir.plan_signature(opt2))

    _both(fn)


def test_rule_marks_non_co_partitioned_join_as_exchange():
    def fn(ns):
        store, visits, patients = _co_store(ns)
        # different dim bounds: the join cannot go partition-wise, but a
        # hash-repartition exchange restores locality
        store.register_table("patients", patients, partition_by="pid",
                             partition_bounds=[6])
        opt, report = _optimize(ns, store, _join_agg_plan(ns))
        join = opt.find("join")[0]
        assert "partition_wise" not in join.attrs
        assert join.attrs.get("exchange") is True
        assert opt.find("group_agg")[0].attrs.get("two_phase") is True
        assert report.fired("distributed_plan")
        # the exchange knob turns the mark off wholesale
        opt2, _ = _optimize(ns, store, _join_agg_plan(ns),
                            enable_exchange=False)
        assert "exchange" not in opt2.find("join")[0].attrs
        assert "partition_wise" not in opt2.find("join")[0].attrs
        return _marks(opt), _marks(opt2), ns.ir.plan_signature(opt)

    _both(fn)


def test_rule_requires_intact_join_key_provenance():
    """A rename/map/attach_column between the scan and the join can bind
    *different values* under the partition key's name; the zone maps say
    nothing about those, so the join must not be marked partition-wise."""
    def rebound_plan(ns):
        plan = ns.ir.Plan()
        v = plan.emit("scan", "RA", [], "table", table="visits")
        pr = plan.emit("project", "RA", [v], "table",
                       columns=["other", "amount"])
        rn = plan.emit("rename", "RA", [pr], "table",
                       mapping={"other": "pid"})
        p = plan.emit("scan", "RA", [], "table", table="patients")
        plan.output = plan.emit("join", "RA", [rn, p], "table", on="pid",
                                how="inner")
        return plan

    def body(ns):
        store, visits, patients = _co_store(ns, n_pids=12, n_rows=60,
                                            bounds=(4, 8))
        # visits gains an `other` column whose values are NOT pid-aligned
        rng = np.random.RandomState(2)
        other = np.asarray(rng.randint(0, 12, 60), np.int32)
        if ns.pkg == "torch":
            other = torch.as_tensor(other)
        shuffled = ns.Table(dict(visits.columns, other=other),
                            visits.valid,
                            visits.schema.with_column(
                                ns.ColumnSchema("other", visits.columns[
                                    "pid"].dtype)))
        store.register_table("visits", shuffled, partition_by="pid",
                             partition_bounds=[4, 8])
        opt, _ = _optimize(ns, store, rebound_plan(ns))
        assert "partition_wise" not in opt.find("join")[0].attrs
        # end-to-end: the sharded service must fall back and still agree
        base = _base(ns, store)
        svc = _sharded(ns, store)
        want = base.run(rebound_plan(ns))
        got = svc.run(rebound_plan(ns))
        assert (_host(got.valid) == _host(want.valid)).all()
        _assert_same_valid_rows(got, want)
        assert svc.stats.sharded_executions == 0
        # a genuinely intact key still qualifies (filter/project keep
        # values)
        opt2, _ = _optimize(ns, store, _join_plan(
            ns, filter_pred=lambda c: c("amount") > 0))
        assert opt2.find("join")[0].attrs.get("partition_wise") is True
        return [(got, ("valid",)), (want, ("valid",))], [base, svc]

    _differential(body)


def test_rule_two_phase_over_single_partitioned_scan():
    """Two-phase aggregation needs no join (and no partition key): any
    partitioned scan subtree qualifies."""
    def fn(ns):
        store = ns.ModelStore()
        t = _table(ns, g=np.asarray([0, 1, 0, 1, 2, 0], np.int32),
                   x=np.arange(6).astype(np.float32))
        store.register_table("t", t, partition_rows=2)
        plan = ns.ir.Plan()
        s = plan.emit("scan", "RA", [], "table", table="t")
        plan.output = plan.emit("group_agg", "RA", [s], "table", key="g",
                                aggs={"sx": ("sum", "x")}, num_groups=3)
        opt, _ = _optimize(ns, store, plan)
        return opt.find("group_agg")[0].attrs.get("two_phase")

    assert _both(fn) is True


def test_rule_skips_agg_with_scan_above_or_second_agg():
    def fn(ns):
        store, *_ = _co_store(ns)
        plan = _join_agg_plan(ns, aggs={"total": ("sum", "amount")})
        # a scan joins the aggregate output downstream: the global stage
        # would need plan inputs of its own -> ineligible
        extra = plan.emit("scan", "RA", [], "table", table="patients")
        plan.output = plan.emit("union", "RA", [plan.output, extra],
                                "table")
        opt, _ = _optimize(ns, store, plan)
        assert "two_phase" not in opt.find("group_agg")[0].attrs
        # two aggregations: neither is "the" split point
        plan2 = _join_agg_plan(ns, aggs={"total": ("sum", "amount")})
        plan2.output = plan2.emit("group_agg", "RA", [plan2.output],
                                  "table", key=None,
                                  aggs={"m": ("max", "total")})
        opt2, _ = _optimize(ns, store, plan2)
        assert all("two_phase" not in n.attrs
                   for n in opt2.find("group_agg"))
        return _marks(opt), _marks(opt2)

    _both(fn)


# ---------------------------------------------------------------------------
# 3. Partial / combine aggregation units
# ---------------------------------------------------------------------------

def _pieces(table, cuts):
    edges = [0] + list(cuts) + [table.capacity]
    return [type(table)({k: v[edges[i]:edges[i + 1]]
                         for k, v in table.columns.items()},
                        table.valid[edges[i]:edges[i + 1]], table.schema)
            for i in range(len(edges) - 1)]


@pytest.mark.parametrize("key,num_groups", [("g", 4), (None, None)])
def test_partial_combine_equals_one_shot(key, num_groups):
    rng = np.random.RandomState(3)
    cols = dict(g=rng.randint(0, 4, 20).astype(np.int32),
                x=rng.randint(-5, 6, 20).astype(np.float32),
                valid=rng.rand(20) < 0.7)
    aggs = {f"{fn}_x": (fn, "x") for fn in AGG_FNS}
    aggs["rows"] = ("count", None)
    t = _table(T, **cols)
    want = rel_ops.group_aggregate(t, key, aggs, num_groups)
    jt = _table(J, **cols)
    for cuts in ([7], [0, 20], [5, 5, 13]):      # incl. empty pieces
        partials = [rel_ops.partial_aggregate(p, key, aggs, num_groups)
                    for p in _pieces(t, cuts)]
        got = rel_ops.combine_partials(partials, key, aggs)
        _assert_tables_equal(got, want)
        # and equal to the reference's partials folded the same way
        jp = [J.ops.partial_aggregate(p, key, aggs, num_groups)
              for p in _pieces(jt, cuts)]
        _assert_tables_equal(got, J.ops.combine_partials(jp, key, aggs))


def test_partial_combine_empty_groups_and_all_invalid():
    aggs = {"lo": ("min", "x"), "hi": ("max", "x"), "n": ("count", None)}

    def fn(ns):
        t = _table(ns, g=np.asarray([0, 0, 3], np.int32),
                   x=np.asarray([1.0, 2.0, 7.0], np.float32),
                   valid=[1, 1, 0])
        want = ns.ops.group_aggregate(t, "g", aggs, 4)
        partials = [ns.ops.partial_aggregate(p, "g", aggs, 4)
                    for p in _pieces(t, [1])]
        got = ns.ops.combine_partials(partials, "g", aggs)
        _assert_tables_equal(got, want)     # groups 1, 2, 3 invalid
        assert not _host(got.valid)[3]      # only-invalid-rows group
        # fully invalid input: every group empty, same as one-shot
        t0 = t.with_valid(ns.mask(np.zeros(3, bool)))
        want0 = ns.ops.group_aggregate(t0, "g", aggs, 4)
        got0 = ns.ops.combine_partials(
            [ns.ops.partial_aggregate(t0, "g", aggs, 4)], "g", aggs)
        _assert_tables_equal(got0, want0)
        return [{k: _host(v).tolist() for k, v in x.columns.items()}
                for x in (got, got0)]

    _both(fn)


def test_partial_aggregate_rejects_non_combinable():
    for ns in (J, T):
        t = _table(ns, g=np.zeros(3, np.int32), x=np.arange(3.0))
        with pytest.raises(ValueError, match="no mergeable partial state"):
            ns.ops.partial_aggregate(t, "g", {"w": ("median", "x")}, 2)


# ---------------------------------------------------------------------------
# 4. Service integration
# ---------------------------------------------------------------------------

def test_service_join_agg_bit_exact_vs_unsharded():
    def body(ns):
        store, *_ = _co_store(ns, n_pids=12, n_rows=80, bounds=(3, 6, 9))
        base = _base(ns, store)
        svc = _sharded(ns, store)
        plan = _join_agg_plan(ns)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        info = svc.shard_info()
        assert info["sharded_executions"] == 1
        assert info["join_executions"] == 1
        assert info["agg_combines"] == 1
        assert info["partial_aggs"] >= 1
        return [(got, "bits"), (want, "bits")], [base, svc]

    _differential(body)


def test_service_join_only_valid_rows_exact():
    def body(ns):
        store, *_ = _co_store(ns, n_pids=10, n_rows=50, bounds=(2, 5, 7),
                              dim_valid=[i % 4 != 1 for i in range(10)])
        base = _base(ns, store)
        svc = _sharded(ns, store)
        plan = _join_plan(ns)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        # inner join: unmatched left rows carry garbage-but-masked right
        # columns, so equality is on the mask and the valid rows
        assert (_host(got.valid) == _host(want.valid)).all()
        _assert_same_valid_rows(got, want)
        assert svc.shard_info()["join_executions"] == 1
        assert svc.shard_info()["agg_combines"] == 0
        return [(got, ("valid",)), (want, ("valid",))], [base, svc]

    _differential(body)


@pytest.mark.timeout_guard(600)
@pytest.mark.parametrize("agg", [True, False], ids=["join_agg", "join"])
def test_service_four_devices_equal_one(agg):
    """Partition-wise joins (and their two-phase aggregation) over four
    CPU devices, one worker thread each: bitwise the one-device answer."""
    store, *_ = _co_store(T, n_pids=16, n_rows=100, bounds=(2, 5, 7, 9, 12))
    plan = _join_agg_plan(T) if agg else _join_plan(T)
    one = _sharded(T, store, shard_morsel_rows=8)
    four = _sharded(T, store, shard_morsel_rows=8, shard_devices=CPU4)
    try:
        want, got = one.run(plan.copy()), four.run(plan.copy())
        _assert_tables_equal(got, want)
        assert four.stats.shard_join_executions == 1
        assert four.stats.shard_waves < one.stats.shard_waves
    finally:
        one.close()
        four.close()


def test_service_global_agg_over_partitioned_scan_via_sql():
    """SQL-level global aggregate over one partitioned table rides the
    two-phase path (no join, no partition key needed)."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, 9, 40).astype(np.float32)
    valid = rng.rand(40) < 0.8
    sql = "SELECT SUM(x) AS s, COUNT(x) AS n, MAX(x) AS m FROM t"

    def body(ns):
        store = ns.ModelStore()
        store.register_table("t", _table(ns, x=x, valid=valid),
                             partition_rows=8)
        base = _base(ns, store)
        svc = _sharded(ns, store)
        want, got = base.run(sql), svc.run(sql)
        _assert_tables_equal(got, want)
        assert svc.shard_info()["agg_combines"] == 1
        return [(got, "bits"), (want, "bits")], [base, svc]

    _differential(body)


def test_service_warm_repeats_compile_nothing():
    def body(ns):
        store, *_ = _co_store(ns)
        svc = _sharded(ns, store)
        plan = _join_agg_plan(ns)
        svc.run(plan.copy())
        before = (svc.stats.cache_misses, svc.stats.shard_compiles,
                  svc.stats.jit_traces)
        for _ in range(3):
            svc.run(plan.copy())
        after = (svc.stats.cache_misses, svc.stats.shard_compiles,
                 svc.stats.jit_traces)
        assert before == after
        assert svc.stats.shard_hits >= 3
        assert svc.stats.jit_traces > 0
        return [], [svc]

    _differential(body, jit=True)


def test_service_pruned_anchor_and_all_pruned():
    def body(ns):
        store, *_ = _co_store(ns, n_pids=12, n_rows=60, bounds=(4, 8))
        base = _base(ns, store)
        svc = _sharded(ns, store)
        plan = _join_agg_plan(ns, filter_pred=lambda c: c("pid") < 4)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        assert svc.stats.partitions_pruned >= 1  # zone maps skipped some
        # every anchor partition pruned: combine folds the identity partial
        plan0 = _join_agg_plan(ns, filter_pred=lambda c: c("pid") < 0)
        want0 = base.run(plan0.copy())
        got0 = svc.run(plan0.copy())
        _assert_tables_equal(got0, want0)
        assert not _host(got0.valid).any()
        return [(got, "bits"), (got0, "bits")], [base, svc]

    _differential(body)


def test_service_override_tables_never_distribute():
    def body(ns):
        store, visits, _ = _co_store(ns)
        base = _base(ns, store)
        svc = _sharded(ns, store)
        sub = ns.Table({k: v[:10] for k, v in visits.columns.items()},
                       visits.valid[:10], visits.schema)
        plan = _join_agg_plan(ns)
        want = base.run(plan.copy(), {"visits": sub})
        got = svc.run(plan.copy(), {"visits": sub})
        _assert_tables_equal(got, want)
        assert svc.stats.sharded_executions == 0
        compiled = svc.compile(plan.copy(), {"visits": sub})
        assert compiled.dist is None
        assert "partition_wise" not in compiled.plan.find("join")[0].attrs
        return [(got, "bits")], [base, svc]

    _differential(body)


def test_service_reregistration_falls_back_to_whole_table():
    """A mid-flight re-registration (racing the invalidation hook) voids
    the co-partitioning proof: the held executable must serve whole-table
    instead of joining misaligned partition pairs."""
    def body(ns):
        store, visits, patients = _co_store(ns)
        svc = _sharded(ns, store)
        compiled = svc.compile(_join_agg_plan(ns))
        assert compiled.dist is not None
        kw = {"jit": False} if ns.pkg == "jax" else {}
        want = ns.core.execute(compiled.plan, store, **kw)
        # different bounds, same partition count: stale alignment is wrong
        store.register_table("patients", patients, partition_by="pid",
                             partition_bounds=[5, 9])
        tabs = {"visits": store.get_table("visits"),
                "patients": store.get_table("patients")}
        out = svc._execute_sharded(compiled, tabs)
        _assert_tables_equal(out, want)
        assert svc.stats.sharded_executions == 0  # whole-table fallback
        return [(out, "bits")], [svc]

    _differential(body)


def test_service_multi_morsel_waves_match_single_morsel():
    """Tiny morsel cap -> several waves per device; results identical to
    the single-morsel placement (combine order is partition order, not
    placement order)."""
    def body(ns):
        store, *_ = _co_store(ns, n_pids=16, n_rows=100,
                              bounds=(2, 5, 7, 9, 12))
        plan = _join_agg_plan(ns, num_groups=3)
        svc_big = _sharded(ns, store, shard_morsel_rows=1 << 16)
        svc_small = _sharded(ns, store, shard_morsel_rows=8)
        a = svc_big.run(plan.copy())
        b = svc_small.run(plan.copy())
        _assert_tables_equal(a, b)
        assert svc_small.shard_info()["partial_aggs"] \
            > svc_big.shard_info()["partial_aggs"]
        return [(a, "bits"), (b, "bits")], [svc_big, svc_small]

    _differential(body)


def test_service_join_with_model_valid_rows_exact():
    """The paper's shape: FK join feeding featurize -> predict, sharded
    partition-wise — predictions per valid row identical to unsharded
    (and to the JAX package's, the pipeline fitted there and carried)."""
    from repro.ml import (LogisticRegression, Pipeline, PipelineMetadata,
                          StandardScaler)
    from repro_torch.ml.convert import pipeline_from_state, pipeline_state
    _s, visits, _p = _co_store(J, n_pids=12, n_rows=80, bounds=(4, 8))
    data = {"amount": np.asarray(visits.column("amount"), np.float32),
            "weight": np.random.RandomState(0).rand(80).astype(np.float32)}
    sc = StandardScaler(["amount", "weight"]).fit(data)
    jpipe = Pipeline([sc], LogisticRegression(steps=10),
                     PipelineMetadata(name="m", task="classification"))
    jpipe.fit(data, (data["amount"] > 0).astype(np.int32))
    pipes = {"jax": jpipe,
             "torch": pipeline_from_state(pipeline_state(jpipe))}

    def body(ns):
        pipe = pipes[ns.pkg]
        store, *_ = _co_store(ns, n_pids=12, n_rows=80, bounds=(4, 8))
        store.register_model("m", pipe)
        plan = _join_plan(ns)
        f = plan.emit("featurize", "MLD", [plan.output], "matrix",
                      pipeline_name="m", featurizers=pipe.featurizers,
                      input_columns=pipe.input_columns())
        m = plan.emit("predict_model", "MLD", [f], "matrix",
                      model=pipe.model, model_name="m", proba=True,
                      task="classification")
        plan.output = plan.emit("attach_column", "RA", [plan.output, m],
                                "table", name="p")
        base = _base(ns, store)
        svc = _sharded(ns, store)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        assert (_host(got.valid) == _host(want.valid)).all()
        _assert_same_valid_rows(got, want)
        assert svc.shard_info()["join_executions"] == 1
        # within each package bitwise (above); across them the score
        # column within the linear-inference tolerance
        return [(got, ("valid", "p")), (want, ("valid", "p"))], [base, svc]

    _differential(body)


# ---------------------------------------------------------------------------
# 5. Bit-exactness property: sharded == unsharded over random shapes
# ---------------------------------------------------------------------------

def _check_distributed_bit_exact(n_pids, fact_pids, fact_vals, fact_valid,
                                 dim_valid, bounds, co_partitioned,
                                 agg_fns):
    fact_pids = np.sort(np.asarray(fact_pids, np.int32))
    aggs = {f"{fn}_{i}": (fn, "amount") for i, fn in enumerate(agg_fns)}
    dim_bounds = list(bounds) if co_partitioned \
        else [b + 1 for b in bounds] + [max(bounds) + 2]

    def body(ns):
        visits = _table(ns, pid=fact_pids,
                        amount=np.asarray(fact_vals, np.float32),
                        valid=fact_valid)
        patients = _table(ns, pid=np.arange(n_pids, dtype=np.int32),
                          region=(np.arange(n_pids) % 3).astype(np.int32),
                          valid=dim_valid)
        store = ns.ModelStore()
        store.register_table("visits", visits, partition_by="pid",
                             partition_bounds=list(bounds))
        store.register_table("patients", patients, partition_by="pid",
                             partition_bounds=dim_bounds)
        plan = _join_agg_plan(ns, aggs=aggs, key="region", num_groups=3)
        base = _base(ns, store)
        svc = _sharded(ns, store, shard_morsel_rows=8)
        want = base.run(plan.copy())
        got = svc.run(plan.copy())
        _assert_tables_equal(got, want)
        if not co_partitioned:
            assert svc.stats.sharded_executions == 0
        return [(got, "bits")], [base, svc]

    _differential(body)


def test_distributed_randomized_sweep():
    """Seeded twin of the hypothesis property below (runs everywhere,
    mirrors the repo convention — change both together)."""
    rng = np.random.RandomState(11)
    for i in range(25):
        n_pids = int(rng.randint(1, 13))
        n_rows = int(rng.randint(1, 40))
        n_bounds = int(rng.randint(1, 5))
        bounds = sorted(int(b) for b in rng.randint(0, n_pids + 1,
                                                    n_bounds))
        _check_distributed_bit_exact(
            n_pids=n_pids,
            fact_pids=rng.randint(0, n_pids, n_rows),
            fact_vals=rng.randint(-4, 5, n_rows),
            fact_valid=rng.rand(n_rows) < rng.choice([0.0, 0.6, 1.0]),
            dim_valid=rng.rand(n_pids) < 0.9,
            bounds=bounds,
            co_partitioned=bool(i % 5),          # every 5th must fall back
            agg_fns=[AGG_FNS[rng.randint(len(AGG_FNS))]
                     for _ in range(rng.randint(1, 4))])


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                # pragma: no cover
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    @given(
        n_pids=st.integers(min_value=1, max_value=12),
        fact=st.lists(st.tuples(st.integers(0, 11),     # pid (clamped)
                                st.integers(-4, 4),     # amount
                                st.booleans()),         # valid
                      min_size=1, max_size=32),
        dim_valid_bits=st.lists(st.booleans(), min_size=12, max_size=12),
        bounds=st.lists(st.integers(0, 12), min_size=1, max_size=4),
        co_partitioned=st.booleans(),
        agg_fns=st.lists(st.sampled_from(AGG_FNS), min_size=1,
                         max_size=3),
    )
    @settings(max_examples=30, deadline=None)
    def test_distributed_bit_exact_property(n_pids, fact, dim_valid_bits,
                                            bounds, co_partitioned,
                                            agg_fns):
        """Partition-wise join + two-phase aggregation == unsharded
        execution, bitwise, across random partition layouts (empty
        partitions included) and row counts, in both packages and equal
        across them; the non-co-partitioned draw falls back to
        whole-table execution and still agrees."""
        _check_distributed_bit_exact(
            n_pids=n_pids,
            fact_pids=[min(p, n_pids - 1) for p, _v, _m in fact],
            fact_vals=[v for _p, v, _m in fact],
            fact_valid=[m for _p, _v, m in fact],
            dim_valid=dim_valid_bits[:n_pids],
            bounds=sorted(bounds),
            co_partitioned=co_partitioned,
            agg_fns=agg_fns)
