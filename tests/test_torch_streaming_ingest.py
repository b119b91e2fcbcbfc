"""Streaming ingest on the port: ``ModelStore.append_rows`` as a
first-class ingest path — incremental zone maps, version lineage,
append-surviving caches, delta-only execution (row-local splice), and the
per-request/per-tenant freshness SLA.  The cases of
``tests/test_streaming_ingest.py`` run on the port, with the pipeline
fitted by the JAX package and carried across; a differential script
appends the same batches in both packages and holds every answer bitwise
to the JAX service (``jit=False``) and ``ServiceStats`` field by field
(``jit=True`` for the trace counters).  The sharded tier's cases —
aggregate partial states extended by delta partitions under the sharded
signature, and the per-serve partition-version checks — run the same
appends through both packages' sharded services and compare alike.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ModelStore
from repro_torch.core.codegen import ExecutionConfig, add_compile_listener
from repro_torch.core.partition import PartitionedTable
from repro_torch.data import hospital_tables
from repro.ml import DecisionTree, Pipeline, PipelineMetadata, StandardScaler
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.relational.table import Table
from repro_torch.serve import ManualClock, PredictionService, TenantPolicy


def _carry(pipe):
    """A pipeline fitted by the JAX package, carried into the port as
    numpy state (the two packages' fits are not bitwise equal)."""
    return pipeline_from_state(pipeline_state(pipe))


pytestmark = pytest.mark.tier1

FEATS = ["age", "gender", "pregnant", "rcount"]
SQL = ("SELECT pid, age, PREDICT(MODEL='los_pi') AS los "
       "FROM patient_info WHERE age > 30")


def _sub(table, lo, hi):
    """Rows ``[lo, hi)`` as a table of ``table``'s own package."""
    return type(table)({k: v[lo:hi] for k, v in table.columns.items()},
                       table.valid[lo:hi], table.schema)


def _table(**cols):
    valid = cols.pop("valid", None)
    t = Table.from_pydict({k: np.asarray(v) for k, v in cols.items()})
    if valid is not None:
        t = t.with_valid(torch.as_tensor(np.asarray(valid, bool)))
    return t


@pytest.fixture(scope="module")
def ingest():
    """Small hospital slice + a fitted pipeline; ``full`` rows beyond
    ``base`` reuse base values, so appends drawn anywhere from ``full``
    keep merged column stats identical (the stats-stable append kind)."""
    # large enough that the optimizer decomposes PREDICT into the
    # featurize/predict_model pipeline (an _EXPENSIVE_OPS subtree): only
    # captured subtrees ride the result cache and hence the delta path
    full = hospital_tables(700, seed=11)["patient_info"]
    base = _sub(full, 0, 500)
    return full, base, _carry(_jax_fit(base))


def _jax_fit(base):
    data = {c: np.asarray(base.column(c)) for c in base.names}
    sc = StandardScaler(FEATS).fit(data)
    pipe = Pipeline([sc], DecisionTree(task="regression", max_depth=6),
                    PipelineMetadata(name="los_pi", task="regression"))
    pipe.fit({k: data[k] for k in FEATS}, data["length_of_stay"])
    return pipe


def _service(base, pipe, **kw):
    store = ModelStore(device="cpu")
    store.register_table("patient_info", base)
    store.register_model("los_pi", pipe)
    return store, PredictionService(store, **kw)


def _reference(cur, pipe):
    """Full recompute over exactly ``cur``'s rows on a cold service."""
    store = ModelStore(device="cpu")
    store.register_table("patient_info", cur)
    store.register_model("los_pi", pipe)
    svc = PredictionService(store)
    try:
        return svc.run(SQL)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Incremental zone-map maintenance
# ---------------------------------------------------------------------------

def test_appended_zone_maps_match_rebuilt():
    rng = np.random.RandomState(3)
    full = _table(x=rng.randint(0, 12, 96).astype(np.int32),
                  v=rng.randn(96).astype(np.float32),
                  valid=rng.rand(96) > 0.2)
    base, batch = _sub(full, 0, 64), _sub(full, 64, 96)
    combined = base.concat_rows(batch)
    base_pt = PartitionedTable.build(base, 16)
    appended = base_pt.append(batch, combined)
    rebuilt = PartitionedTable.build(combined, 16)
    assert ([(p.start, p.stop) for p in appended.partitions]
            == [(p.start, p.stop) for p in rebuilt.partitions])
    for pa, pb in zip(appended.partitions, rebuilt.partitions):
        assert pa.zone == pb.zone, f"partition [{pa.start},{pa.stop})"
    # prefix Partition objects (and their zone maps) are reused, not rebuilt
    for old, new in zip(base_pt.partitions, appended.partitions):
        assert new is old


def test_append_opens_new_partition_at_old_boundary():
    # A ragged last partition is never extended: the batch starts its own
    # partition at the old capacity, so prefix pruning proofs stay valid.
    full = _table(x=np.arange(30, dtype=np.int32))
    base, batch = _sub(full, 0, 20), _sub(full, 20, 30)  # 16 + ragged 4
    appended = PartitionedTable.build(base, 16).append(
        batch, base.concat_rows(batch))
    starts = [(p.start, p.stop) for p in appended.partitions]
    assert starts[:2] == [(0, 16), (16, 20)]
    assert starts[2][0] == 20


def test_empty_append_is_identity():
    full = _table(x=np.arange(16, dtype=np.int32))
    base = _sub(full, 0, 16)
    pt = PartitionedTable.build(base, 8)
    out = pt.append(_sub(full, 16, 16), base)
    assert out.partitions == pt.partitions

    store = ModelStore(device="cpu")
    store.register_table("t", base, partition_rows=8)
    v0 = store.table_version("t")
    assert store.append_rows("t", _sub(full, 16, 16)) == v0


def test_keyed_append_rejects_straddling_keys():
    base = _table(k=np.asarray([0, 0, 1, 1, 2, 2], np.int32),
                  x=np.arange(6, dtype=np.float32))
    store = ModelStore(device="cpu")
    store.register_table("t", base, partition_rows=2, partition_by="k")
    bad = _table(k=np.asarray([2, 3], np.int32),
                 x=np.asarray([9.0, 9.0], np.float32))
    with pytest.raises(ValueError, match="strictly after"):
        store.append_rows("t", bad)
    good = _table(k=np.asarray([3, 3], np.int32),
                  x=np.asarray([9.0, 9.0], np.float32))
    store.append_rows("t", good)
    assert store.get_table("t").capacity == 8


# ---------------------------------------------------------------------------
# Version lineage + invalidation kinds
# ---------------------------------------------------------------------------

def test_append_lineage_and_invalidation_kind():
    rng = np.random.RandomState(0)
    full = _table(x=rng.randint(0, 8, 48).astype(np.int32))
    base = _sub(full, 0, 32)
    store = ModelStore(device="cpu")
    store.register_table("t", base)
    events = []
    unsub = store.add_invalidation_listener(
        lambda kind, name: events.append((kind, name)))
    v0 = store.table_version("t")

    # in-domain batch: stats provably unchanged -> kind='append'
    v1 = store.append_rows("t", _sub(full, 32, 40))
    assert v1 == v0 + 1
    assert events[-1] == ("append", "t")
    assert store.version_lineage("t") == ((v0, 32), (v1, 40))

    # out-of-domain batch: max extends -> full kind='table' invalidation
    store.append_rows("t", _table(x=np.asarray([99], np.int32)))
    assert events[-1] == ("table", "t")
    unsub()


# ---------------------------------------------------------------------------
# Delta serving: row-local splice
# ---------------------------------------------------------------------------

def test_row_local_delta_bitwise_and_zero_warm_compiles(
        ingest, assert_tables_equal):
    full, base, pipe = ingest
    store, svc = _service(base, pipe)
    compiles = []
    unsub = add_compile_listener(compiles.append)
    try:
        svc.run(SQL)
        cur = base
        for cycle in range(1, 4):
            batch = _sub(full, 10 * cycle, 10 * cycle + 30)
            store.append_rows("patient_info", batch)
            cur = cur.concat_rows(batch)
            n0, jt0 = len(compiles), svc.stats.jit_traces
            out = svc.run(SQL)
            if cycle >= 2:
                # append path is compile- and trace-free once the delta
                # twin exists (first cycle pays the residual + twin once)
                assert len(compiles) == n0
                assert svc.stats.jit_traces == jt0
            assert_tables_equal(out, _reference(cur, pipe))
        assert svc.stats.appends_observed == 3
        assert svc.stats.delta_serves >= 2
        assert svc.stats.delta_fallbacks == 0
        assert svc.stats.delta_rows_scanned <= 3 * 30 + 2
    finally:
        unsub()
        svc.close()


def test_delta_matches_full_recompute_random_appends(
        ingest, assert_tables_equal):
    pytest.importorskip("hypothesis")
    from hypothesis import example, given, settings
    from hypothesis import strategies as st

    full, base, pipe = ingest

    @example(sizes=[0])            # empty batch: version must not move
    @example(sizes=[1])            # single-row batch
    @example(sizes=[0, 1, 48])
    @given(sizes=st.lists(st.integers(min_value=0, max_value=48),
                          min_size=1, max_size=3))
    @settings(max_examples=8, deadline=None)
    def check(sizes):
        store, svc = _service(base, pipe)
        try:
            svc.run(SQL)
            cur = base
            for i, s in enumerate(sizes):
                lo = (17 * i) % 120
                batch = _sub(full, lo, lo + s)
                store.append_rows("patient_info", batch)
                cur = cur.concat_rows(batch)
                assert_tables_equal(svc.run(SQL), _reference(cur, pipe))
            assert svc.stats.delta_fallbacks == 0
        finally:
            svc.close()

    check()


# ---------------------------------------------------------------------------
# Delta serving: aggregate state reuse (incremental view maintenance)
# ---------------------------------------------------------------------------

def _agg_ns(pkg):
    if pkg == "jax":
        from repro.core import ExecutionConfig as XConfig
        from repro.core import ModelStore as XStore
        from repro.relational.table import Table as XTable
        from repro.serve import PredictionService as XService
        return XConfig, (lambda: XStore()), XTable, XService
    return (ExecutionConfig, (lambda: ModelStore(device="cpu")), Table,
            PredictionService)


def _agg_script(pkg, cols, base_rows, batches, sql, jit):
    """Register the first ``base_rows`` rows of ``cols`` partitioned by 8,
    serve ``sql`` through a sharded service, then append each ``(lo,
    hi)`` row range of ``cols`` and serve again; every answer is checked
    against a cold whole-table service over exactly the current rows.
    Returns the answers, the per-cycle compile/trace deltas, and the
    stats."""
    XConfig, XStore, XTable, XService = _agg_ns(pkg)
    full = XTable.from_pydict(cols)
    base = _sub(full, 0, base_rows)
    store = XStore()
    store.register_table("t", base, partition_rows=8)
    svc = XService(store, jit=jit, execution_config=XConfig(
        sharded=True, shard_min_bucket_rows=4, shard_morsel_rows=16))
    outs, deltas = [svc.run(sql)], []
    try:
        cur = base
        for lo, hi in batches:
            batch = _sub(full, lo, hi)
            store.append_rows("t", batch)
            cur = cur.concat_rows(batch)
            before = (svc.stats.cache_misses, svc.stats.jit_traces,
                      svc.stats.shard_compiles)
            out = svc.run(sql)
            deltas.append(tuple(
                a - b for a, b in zip((svc.stats.cache_misses,
                                       svc.stats.jit_traces,
                                       svc.stats.shard_compiles), before)))
            ref_store = XStore()
            ref_store.register_table("t", cur, partition_rows=8)
            ref_svc = XService(ref_store, jit=jit)
            try:
                want = ref_svc.run(sql)
            finally:
                ref_svc.close()
            assert (np.asarray(_host(out.valid))
                    == np.asarray(_host(want.valid))).all()
            for k in want.columns:
                assert (_host(out.columns[k])
                        == _host(want.columns[k])).all(), k
            outs.append(out)
        return outs, deltas, dataclasses.asdict(svc.stats)
    finally:
        svc.close()


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agg_differential(cols, base_rows, batches, sql, jit):
    """The same appends through both packages' sharded services: answers
    bitwise equal (unjitted), compile deltas and stats field by field."""
    jouts, jdeltas, jstats = _agg_script("jax", cols, base_rows, batches,
                                         sql, jit)
    touts, tdeltas, tstats = _agg_script("torch", cols, base_rows, batches,
                                         sql, jit)
    assert tstats == jstats and tdeltas == jdeltas
    if not jit:
        for jo, to in zip(jouts, touts):
            assert (_host(to.valid) == _host(jo.valid)).all()
            for k in jo.columns:
                assert _host(to.columns[k]).dtype \
                    == _host(jo.columns[k]).dtype, k
                assert (_host(to.columns[k]) == _host(jo.columns[k])).all()
    return tdeltas, tstats


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("sql", [
    "SELECT SUM(x) AS s, COUNT(x) AS n, AVG(x) AS a, MIN(x) AS lo, "
    "MAX(x) AS hi FROM t",
    "SELECT k, SUM(x) AS s, COUNT(x) AS n, AVG(x) AS a FROM t GROUP BY k",
], ids=["global", "keyed"])
def test_agg_delta_bitwise_and_zero_compiles(sql, jit):
    rng = np.random.RandomState(5)
    cols = {"x": rng.randint(0, 9, 96).astype(np.float32),
            "k": rng.randint(0, 3, 96).astype(np.int32)}
    # batches drawn from the base's own rows: stats-stable appends
    batches = [(64 - 16 * c, 64 - 16 * (c - 1)) for c in range(1, 3)]
    deltas, stats = _agg_differential(cols, 64, batches, sql, jit)
    # delta partitions share the normal serve's shard signature, so even
    # the first delta cycle re-traces nothing
    assert deltas == [(0, 0, 0)] * 2
    assert stats["delta_serves"] == 2
    assert stats["delta_fallbacks"] == 0
    assert stats["prefix_supersedes"] >= 1


def test_stats_changing_append_falls_back_to_full():
    rng = np.random.RandomState(9)
    cols = {"x": np.concatenate([rng.randint(0, 9, 64),
                                 np.full(8, 500)]).astype(np.float32),
            "k": np.concatenate([rng.randint(0, 3, 64),
                                 np.ones(8)]).astype(np.int32)}
    # max(x) grows past the base's: a 'table' invalidation, full serve
    _deltas, stats = _agg_differential(
        cols, 64, [(64, 72)], "SELECT k, SUM(x) AS s FROM t GROUP BY k",
        jit=False)
    assert stats["delta_serves"] == 0


def test_mid_flight_append_serves_current_rows():
    # A plan compiled before the append holds pre-append partition
    # metadata; the per-serve version check must re-resolve partitions so
    # the appended rows are scanned (never silently dropped).
    cols = {"x": np.arange(96, dtype=np.float32),
            "k": (np.arange(96) % 3).astype(np.int32)}
    # out-of-domain: x extends past the base's max
    _agg_differential(cols, 64, [(64, 96)],
                      "SELECT k, SUM(x) AS s FROM t GROUP BY k", jit=False)


# ---------------------------------------------------------------------------
# Freshness SLA (max_staleness_s) under the fake clock
# ---------------------------------------------------------------------------

def test_request_level_staleness_sla(ingest, assert_tables_equal):
    full, base, pipe = ingest
    clock = ManualClock()
    store, svc = _service(base, pipe, clock=clock)
    try:
        pre = svc.run(SQL)
        store.append_rows("patient_info", _sub(full, 0, 40))
        clock.advance(1.0)
        within = svc.run(SQL, max_staleness_s=5.0)
        assert svc.stats.stale_serves == 1
        assert_tables_equal(within, pre)     # pre-append snapshot, bitwise
        clock.advance(10.0)
        lapsed = svc.run(SQL, max_staleness_s=5.0)
        assert svc.stats.stale_serves == 1   # budget lapsed: no stale serve
        assert lapsed.capacity == 540
    finally:
        svc.close()


def test_per_tenant_staleness_sla(ingest, assert_tables_equal):
    full, base, pipe = ingest
    clock = ManualClock()
    store, svc = _service(
        base, pipe, clock=clock,
        tenants={"analytics": TenantPolicy(max_staleness_s=30.0)})
    try:
        lax = svc.session(tenant="analytics")
        pre = lax.sql(SQL)
        store.append_rows("patient_info", _sub(full, 0, 40))
        clock.advance(5.0)
        # tenant policy allows the pre-append snapshot within its SLA ...
        assert_tables_equal(lax.sql(SQL), pre)
        assert svc.stats.stale_serves == 1
        # ... while a tenant without a policy always sees current rows
        live = svc.session()
        assert live.sql(SQL).capacity == 540
        # once the tenant SLA lapses, the stale tier closes for it too
        clock.advance(26.0)                  # 31s since append > 30s SLA
        assert lax.sql(SQL).capacity == 540
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Differential: the same appends and serves through both packages
# ---------------------------------------------------------------------------

def _ingest_script(store, svc, clock, full):
    """Warm capture, three in-domain appends served by delta execution,
    then an append served stale within the request's freshness SLA, then
    served fresh."""
    outs = [svc.run(SQL)]
    for cycle in range(1, 4):
        store.append_rows("patient_info",
                          _sub(full, 10 * cycle, 10 * cycle + 30))
        outs.append(svc.run(SQL))
    store.append_rows("patient_info", _sub(full, 0, 40))
    clock.advance(1.0)
    outs.append(svc.run(SQL, max_staleness_s=5.0))
    outs.append(svc.run(SQL))
    outs.append(svc.session(tenant="t").sql(SQL))
    return outs


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_ingest_script_matches_jax(ingest, jit):
    from dataclasses import asdict

    from repro.core import ModelStore as JModelStore
    from repro.data import hospital_tables as jhospital
    from repro.serve import ManualClock as JManualClock
    from repro.serve import PredictionService as JService
    full, base, pipe = ingest
    jfull = jhospital(700, seed=11)["patient_info"]
    jbase = _sub(jfull, 0, 500)
    jstore, tstore = JModelStore(), ModelStore(device="cpu")
    jstore.register_table("patient_info", jbase)
    jstore.register_model("los_pi", _jax_fit(jbase))
    tstore.register_table("patient_info", base)
    tstore.register_model("los_pi", pipe)
    assert jstore.model_digest("los_pi") == tstore.model_digest("los_pi")
    jclock, tclock = JManualClock(), ManualClock()
    jsvc = JService(jstore, jit=jit, clock=jclock)
    tsvc = PredictionService(tstore, jit=jit, clock=tclock)
    jouts = _ingest_script(jstore, jsvc, jclock, jfull)
    touts = _ingest_script(tstore, tsvc, tclock, full)
    if not jit:       # a jitted XLA plan may differ by an FMA ulp
        for jo, to in zip(jouts, touts):
            np.testing.assert_array_equal(to.valid.numpy(),
                                          np.asarray(jo.valid))
            for k in jo.columns:
                np.testing.assert_array_equal(to.columns[k].numpy(),
                                              np.asarray(jo.columns[k]))
    assert asdict(tsvc.stats) == asdict(jsvc.stats)
    s = tsvc.stats
    assert s.appends_observed == 4 and s.delta_serves >= 3
    assert s.stale_serves == 1 and s.delta_fallbacks == 0
    jsvc.close()
    tsvc.close()
