"""The port's prediction-query serving layer (``repro_torch.serve.
prediction_service``): plan-signature cache, chunked execution,
micro-batch coalescing.  The cases of ``tests/test_prediction_service.py``
and the unsharded properties of ``tests/test_serving_properties.py``, run
on the port (pipelines fitted by the JAX package and carried across), and
differential scripts that drive the port's service and the JAX package's
through the same calls: answers bitwise equal to the JAX service built
with ``jit=False`` (a jitted XLA plan may contract filter/map arithmetic
to FMA, which eager JAX and the port do not), and ``ServiceStats`` equal
field by field — with ``jit=True`` on both sides for the trace counters.

Key guarantees under test:
- a repeat of an identical query performs ZERO plan compilations (asserted
  through the ``codegen`` compile-counter hook);
- the plan signature is invariant to node-id aliasing and table column
  order, but sensitive to model *content* (retrained weights miss the cache);
- chunked (morsel) execution is bit-exact vs whole-table execution,
  including ragged tails;
- concurrent requests sharing a signature coalesce into one execution.
"""

import threading
import time

import numpy as np
import pytest

from repro_torch.core import ModelStore, parse_query
from repro_torch.core import codegen
from repro_torch.core.codegen import add_compile_listener
from repro_torch.core.ir import Category, Node, Plan, plan_signature
from repro_torch.core.model_store import content_fingerprint
from repro_torch.data import hospital_tables
from repro.ml import DecisionTree, Pipeline, PipelineMetadata, StandardScaler
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.relational.table import Table
from repro_torch.relational.expr import col
from repro_torch.serve import PredictionService


def _carry(pipe):
    """A pipeline fitted by the JAX package, carried into the port as
    numpy state (the two packages' fits are not bitwise equal)."""
    return pipeline_from_state(pipeline_state(pipe))


N_ROWS = 600
FEATS = ["age", "gender", "pregnant", "rcount"]
SQL = ("SELECT pid, age, PREDICT(MODEL='los_pi') AS los "
       "FROM patient_info WHERE age > 30")


def _jax_pipeline(data, max_depth=6):
    sc = StandardScaler(FEATS).fit(data)
    pipe = Pipeline([sc], DecisionTree(task="regression",
                                       max_depth=max_depth),
                    PipelineMetadata(name="los_pi", task="regression"))
    pipe.fit({k: data[k] for k in FEATS}, data["length_of_stay"])
    return pipe


def _pipeline(data, max_depth=6):
    return _carry(_jax_pipeline(data, max_depth))


@pytest.fixture(scope="module")
def store():
    store = ModelStore(device="cpu")
    for n, t in hospital_tables(N_ROWS, seed=7).items():
        store.register_table(n, t)
    pi = store.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    store.register_model("los_pi", _pipeline(data))
    return store


def _sub_table(table: Table, lo: int, hi: int) -> Table:
    return Table({k: v[lo:hi] for k, v in table.columns.items()},
                 table.valid[lo:hi], table.schema)


def _table_arrays(t: Table):
    return ({k: np.asarray(v) for k, v in t.columns.items()},
            np.asarray(t.valid))


# ---------------------------------------------------------------------------
# Cache behaviour
# ---------------------------------------------------------------------------

def test_second_run_zero_plan_compiles(store):
    service = PredictionService(store)
    compiled_plans = []
    unsubscribe = add_compile_listener(compiled_plans.append)
    try:
        out1 = service.run(SQL)
        assert len(compiled_plans) == 1
        assert service.stats.cache_misses == 1
        out2 = service.run(SQL)                # warm: zero compilations
        assert len(compiled_plans) == 1
        assert service.stats.cache_hits == 1
    finally:
        unsubscribe()
    c1, v1 = _table_arrays(out1)
    c2, v2 = _table_arrays(out2)
    assert (v1 == v2).all()
    for k in c1:
        assert (c1[k] == c2[k]).all()


def test_compile_counter_counts(store):
    before = codegen.compile_stats["plans_compiled"]
    service = PredictionService(store)
    service.run(SQL)
    service.run(SQL)
    service.run(SQL)
    assert codegen.compile_stats["plans_compiled"] == before + 1


def test_lru_eviction(store):
    service = PredictionService(store, max_cache_entries=2)
    service.run("SELECT pid FROM patient_info WHERE age > 10")
    service.run("SELECT pid FROM patient_info WHERE age > 20")
    service.run("SELECT pid FROM patient_info WHERE age > 30")
    info = service.cache_info()
    assert info["entries"] == 2
    assert info["evictions"] == 1


# ---------------------------------------------------------------------------
# Signature semantics
# ---------------------------------------------------------------------------

def test_signature_invariant_to_node_id_aliases(store):
    """The same logical plan built under different node ids (the SQL
    frontend's fresh-id counter, or hand-chosen aliases) hashes identically."""
    p1 = parse_query(SQL, store)
    p2 = parse_query(SQL, store)        # fresh auto-generated ids
    assert plan_signature(p1) == plan_signature(p2)

    def hand_built(alias: str) -> Plan:
        plan = Plan()
        scan = plan.add(Node("scan", Category.RA, [], {"table": "patient_info"},
                             "table", id=f"{alias}_scan"))
        filt = plan.add(Node("filter", Category.RA, [scan],
                             {"predicate": col("age") > 30}, "table",
                             id=f"{alias}_filter"))
        plan.output = filt
        return plan

    assert plan_signature(hand_built("a")) == plan_signature(hand_built("zz"))


def test_signature_invariant_to_column_order(store):
    """Cache keys hash table schemas sorted by column name, so two catalogs
    whose tables declare the same columns in different order share keys."""
    pi = store.get_table("patient_info")
    names = list(pi.names)
    reordered = Table({n: pi.columns[n] for n in reversed(names)},
                      pi.valid, pi.schema.select(list(reversed(names))))
    other = ModelStore(device="cpu")
    other.register_table("patient_info", reordered)
    other.register_model("los_pi", store.get_model("los_pi"))

    s1 = PredictionService(store)
    s2 = PredictionService(other)
    k1, _ = s1._cache_key(parse_query(SQL, store), None)
    k2, _ = s2._cache_key(parse_query(SQL, other), None)
    assert k1 == k2


def test_signature_sensitive_to_model_content(store):
    pi = store.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    retrained = _pipeline(data, max_depth=3)

    other = ModelStore(device="cpu")
    other.register_table("patient_info", pi)
    other.register_model("los_pi", retrained)

    sig_orig = plan_signature(parse_query(SQL, store))
    sig_new = plan_signature(parse_query(SQL, other))
    assert sig_orig != sig_new
    assert content_fingerprint(store.get_model("los_pi")) \
        != content_fingerprint(retrained)
    # byte-identical re-registration digests identically
    v2 = other.register_model("los_pi", retrained)
    assert other.model_digest("los_pi", 1) == other.model_digest("los_pi", v2)


def test_udf_signature_sensitive_to_constants_and_closures(store):
    """co_code alone cannot distinguish `+1` from `+2` (the constant lives
    in co_consts) — the signature must."""
    def build(fn):
        plan = Plan()
        scan = plan.emit("scan", Category.RA, [], "table",
                         table="patient_info")
        plan.output = plan.emit("udf", Category.UDF, [scan], "vector", fn=fn)
        return plan

    s_plus1 = plan_signature(build(lambda cols: cols["age"] + 1))
    s_plus2 = plan_signature(build(lambda cols: cols["age"] + 2))
    assert s_plus1 != s_plus2

    def closed_over(k):
        return lambda cols: cols["age"] + k

    assert plan_signature(build(closed_over(3))) \
        != plan_signature(build(closed_over(4)))


def test_fingerprint_covers_globals_and_private_attrs():
    """Identical bytecode must not collide: the referenced global name
    (abs vs len, np.log vs np.exp) and underscored fitted state (e.g.
    Bucketizer._kept) are part of an artifact's content."""
    assert content_fingerprint(lambda x: abs(x)) \
        != content_fingerprint(lambda x: len(x))

    def log_udf(cols):
        return np.log(cols["age"])

    def exp_udf(cols):
        return np.exp(cols["age"])

    assert content_fingerprint(log_udf) != content_fingerprint(exp_udf)

    class Fitted:
        def __init__(self, w):
            self._w = w

    assert content_fingerprint(Fitted(1)) != content_fingerprint(Fitted(2))
    # ...and constants inside *nested* functions
    assert content_fingerprint(lambda cols: (lambda v: v + 1)(cols)) \
        != content_fingerprint(lambda cols: (lambda v: v + 2)(cols))


def test_zero_cache_entries_disables_caching(store):
    service = PredictionService(store, max_cache_entries=0)
    sql = "SELECT pid FROM patient_info WHERE age > 10"
    out1 = service.run(sql)
    out2 = service.run(sql)
    assert service.cache_info()["entries"] == 0
    assert (np.asarray(out1.valid) == np.asarray(out2.valid)).all()


def test_stats_update_invalidates_cache_key(store):
    """Stats-based pruning bakes catalog stats into the executable, so
    re-registering a table with different stats must miss the cache."""
    other = ModelStore(device="cpu")
    pi = store.get_table("patient_info")
    other.register_table("patient_info", pi)
    other.register_model("los_pi", store.get_model("los_pi"))
    service = PredictionService(other)
    k1, _ = service._cache_key(parse_query(SQL, other), None)
    wider = pi.with_columns({"age": np.asarray(pi.column("age")) + 100})
    other.register_table("patient_info", wider)
    k2, _ = service._cache_key(parse_query(SQL, other), None)
    assert k1 != k2


def test_override_tables_bypass_stats_pruning(store):
    """Caller-supplied tables may violate catalog stats; predictions must
    match an unpruned execution even for out-of-range rows."""
    from repro_torch.core import OptimizerConfig
    pi = store.get_table("patient_info")
    out_of_range = pi.with_columns(
        {"age": np.asarray(pi.column("age"), np.float32) + 500.0})
    service = PredictionService(store)
    sql = "SELECT pid, PREDICT(MODEL='los_pi') AS los FROM patient_info"
    got = service.run(sql, {"patient_info": out_of_range})

    unpruned = PredictionService(
        store, optimizer_config=OptimizerConfig(enable_model_pruning=False))
    want = unpruned.run(sql, {"patient_info": out_of_range})
    cg, vg = _table_arrays(got)
    cw, vw = _table_arrays(want)
    assert (vg == vw).all()
    for k in cw:
        np.testing.assert_allclose(cg[k], cw[k], rtol=1e-6)


def test_optimizer_report_carries_signatures(store):
    from repro_torch.core import CrossOptimizer
    plan = parse_query(SQL, store)
    _, report = CrossOptimizer(store).optimize(plan)
    assert report.input_signature == plan_signature(plan)
    assert report.plan_signature is not None
    assert report.referenced_models == ("los_pi",)


# ---------------------------------------------------------------------------
# Chunked (morsel) execution
# ---------------------------------------------------------------------------

def test_chunked_bit_exact_with_ragged_tail(store):
    whole = PredictionService(store)
    chunked = PredictionService(store, chunk_rows=128)   # 600 -> 4 + tail 88
    o1, o2 = whole.run(SQL), chunked.run(SQL)
    assert chunked.stats.chunks_executed == 5
    c1, v1 = _table_arrays(o1)
    c2, v2 = _table_arrays(o2)
    assert (v1 == v2).all()
    for k in c1:
        assert (c1[k] == c2[k]).all(), f"column {k} diverged under chunking"


def test_chunked_single_plan_compile(store):
    before = codegen.compile_stats["plans_compiled"]
    service = PredictionService(store, chunk_rows=100)
    service.run(SQL)
    service.run(SQL)
    assert codegen.compile_stats["plans_compiled"] == before + 1


def test_join_query_falls_back_to_whole_table(store):
    # hematocrit keeps the join alive through join-elimination
    sql = ("SELECT pid, hematocrit FROM patient_info JOIN blood_tests ON pid "
           "WHERE age > 30")
    service = PredictionService(store, chunk_rows=64)
    compiled = service.compile(sql)
    assert compiled.chunk_table is None      # join is not row-local
    out = service.run(sql)
    assert service.stats.chunks_executed == 0
    assert np.asarray(out.valid).any()


# ---------------------------------------------------------------------------
# Micro-batch admission
# ---------------------------------------------------------------------------

def test_coalesced_requests_single_execution(store):
    pi = store.get_table("patient_info")
    service = PredictionService(store)
    parts = [(0, 100), (100, 350), (350, 600)]
    tickets = [service.submit(SQL, {"patient_info": _sub_table(pi, lo, hi)})
               for lo, hi in parts]
    assert service.flush() == 3
    assert service.stats.batch_executions == 1
    assert service.stats.coalesced_requests == 2

    reference = PredictionService(store)
    for ticket, (lo, hi) in zip(tickets, parts):
        got = ticket.result()
        want = reference.run(SQL, {"patient_info": _sub_table(pi, lo, hi)})
        cg, vg = _table_arrays(got)
        cw, vw = _table_arrays(want)
        assert (vg == vw).all()
        for k in cw:
            assert (cg[k] == cw[k]).all()


def test_identical_catalog_requests_share_one_execution(store):
    service = PredictionService(store)
    t1 = service.submit(SQL)
    t2 = service.submit(SQL)
    t3 = service.submit(SQL)
    assert service.flush() == 3
    assert service.stats.batch_executions == 1
    assert service.stats.coalesced_requests == 2
    v1 = np.asarray(t1.result().valid)
    assert (v1 == np.asarray(t3.result().valid)).all()
    assert t2.done


@pytest.mark.timeout_guard(300)
def test_concurrent_run_threads(store):
    pi = store.get_table("patient_info")
    service = PredictionService(store)
    service.run(SQL)                         # warm the cache
    results = {}
    errors = []

    def worker(i, lo, hi):
        try:
            results[i] = service.run(
                SQL, {"patient_info": _sub_table(pi, lo, hi)})
        except Exception as e:               # pragma: no cover
            errors.append(e)

    spans = [(0, 200), (200, 400), (400, 600), (0, 600)]
    threads = [threading.Thread(target=worker, args=(i, lo, hi))
               for i, (lo, hi) in enumerate(spans)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 4
    reference = PredictionService(store)
    for i, (lo, hi) in enumerate(spans):
        want = reference.run(SQL, {"patient_info": _sub_table(pi, lo, hi)})
        cg, vg = _table_arrays(results[i])
        cw, vw = _table_arrays(want)
        assert (vg == vw).all()
        for k in cw:
            assert (cg[k] == cw[k]).all()


def test_failed_request_reports_error(store):
    service = PredictionService(store)
    ticket = service.submit("SELECT pid FROM no_such_table")
    service.flush()
    with pytest.raises(KeyError):
        ticket.result()


def test_ticket_result_timeout_raises(store):
    """Regression: an unserved ticket must raise TimeoutError on expiry,
    never silently return None (indistinguishable from a null result)."""
    service = PredictionService(store)
    ticket = service.submit(SQL)          # queued, deliberately not flushed
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        ticket.result(timeout=0.05)
    assert time.perf_counter() - t0 < 5.0
    assert not ticket.done
    service.flush()                       # same ticket still serveable after
    out = ticket.result(timeout=30.0)
    assert np.asarray(out.valid).any()


@pytest.mark.timeout_guard(300)
def test_concurrent_submit_flush_stress(store):
    """N threads submitting and flushing against one service: no deadlock,
    every ticket resolves, and the stats ledger balances —
    hits + misses == compile-cache lookups == executions issued, and
    executions + coalesced == requests served."""
    service = PredictionService(store)
    queries = [
        SQL,
        "SELECT pid, age, PREDICT(MODEL='los_pi') AS los "
        "FROM patient_info WHERE age > 45",
        "SELECT pid, PREDICT(MODEL='los_pi') AS los FROM patient_info",
    ]
    n_threads, per_thread = 8, 6
    before_compiles = codegen.compile_stats["plans_compiled"]
    results, errors = {}, []
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        try:
            barrier.wait(timeout=30)
            for i in range(per_thread):
                ticket = service.submit(queries[(tid + i) % len(queries)])
                service.flush()
                results[(tid, i)] = ticket.result(timeout=60.0)
        except Exception as e:            # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "worker deadlocked"
    assert not errors
    assert len(results) == n_threads * per_thread
    for out in results.values():
        assert np.asarray(out.valid).any()

    s = service.stats
    # every group serve performs exactly one cache lookup and one execution
    assert s.cache_hits + s.cache_misses == s.batch_executions
    assert s.batch_executions + s.coalesced_requests \
        == n_threads * per_thread
    # every plan compile is accounted for: one per miss, plus any splice
    # upgrades / rematerializations (none expected for disjoint prefixes)
    assert codegen.compile_stats["plans_compiled"] - before_compiles \
        == s.cache_misses + s.splice_upgrades + s.rematerializations
    assert s.rematerializations == 0


# ---------------------------------------------------------------------------
# Serving properties (tests/test_serving_properties.py, unsharded cases)
# ---------------------------------------------------------------------------

class _Model:
    """Minimal model-like artifact: content is one weight array."""

    def __init__(self, w):
        self.w = np.asarray(w, np.float32)


def _build_plan(ids, attr_order, threshold, weights) -> Plan:
    """The same logical plan under caller-chosen node ids and attr-dict
    insertion orders."""
    plan = Plan()
    scan = plan.add(Node("scan", Category.RA, [],
                         {"table": "patient_info"}, "table", id=ids[0]))
    filt = plan.add(Node("filter", Category.RA, [scan],
                         {"predicate": col("age") > threshold}, "table",
                         id=ids[1]))
    attrs = {"model": _Model(weights), "task": "regression", "proba": False}
    if attr_order:
        attrs = dict(reversed(list(attrs.items())))
    plan.output = plan.add(Node("predict_model", Category.MLD, [filt],
                                attrs, "vector", id=ids[2]))
    return plan


def test_signature_properties_match_jax():
    """plan_signature is a pure function of structure and content: the
    same under node-id renumbering and attr-dict insertion order,
    different under a weight change — and equal to the JAX package's
    signature of the same plan."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from repro.core.ir import Category as JCategory
    from repro.core.ir import Node as JNode
    from repro.core.ir import Plan as JPlan
    from repro.core.ir import plan_signature as jsig
    from repro.relational.expr import col as jcol

    def jax_plan(ids, threshold, weights):
        plan = JPlan()
        scan = plan.add(JNode("scan", JCategory.RA, [],
                              {"table": "patient_info"}, "table", id=ids[0]))
        filt = plan.add(JNode("filter", JCategory.RA, [scan],
                              {"predicate": jcol("age") > threshold},
                              "table", id=ids[1]))
        plan.output = plan.add(JNode(
            "predict_model", JCategory.MLD, [filt],
            {"model": _Model(weights), "task": "regression",
             "proba": False}, "vector", id=ids[2]))
        return plan

    @settings(max_examples=25, deadline=None)
    @given(alias=st.text(alphabet="abcxyz", min_size=1, max_size=6),
           offset=st.integers(0, 1000), reorder=st.booleans(),
           threshold=st.integers(-5, 90),
           w=st.lists(st.integers(-100, 100), min_size=1, max_size=4),
           idx=st.integers(0, 3), delta=st.integers(1, 7))
    def check(alias, offset, reorder, threshold, w, idx, delta):
        ids_a = [f"{alias}_{i}" for i in range(3)]
        ids_b = [f"zz_{alias}_{i + offset}" for i in range(3)]
        p1 = _build_plan(ids_a, False, threshold, w)
        assert plan_signature(p1) == plan_signature(
            _build_plan(ids_b, reorder, threshold, w))
        assert plan_signature(p1) == jsig(jax_plan(ids_a, threshold, w))
        w2 = list(w)
        w2[idx % len(w2)] += delta          # guaranteed content change
        assert plan_signature(p1) != plan_signature(
            _build_plan(ids_a, False, threshold, w2))
        assert content_fingerprint(_Model(w)) \
            != content_fingerprint(_Model(w2))

    check()


PROP_SQL = ("SELECT pid, PREDICT(MODEL='los_pi') AS p FROM patient_info "
            "WHERE age > 30")
CHUNK = 16


def _chunk_pair(store, n):
    small = ModelStore(device="cpu")
    small.register_table("patient_info",
                         _sub_table(store.get_table("patient_info"), 0, n))
    small.register_model("los_pi", store.get_model("los_pi"))
    whole = PredictionService(small, jit=False)
    chunked = PredictionService(small, jit=False, chunk_rows=CHUNK)
    return whole.run(PROP_SQL), chunked.run(PROP_SQL), chunked


@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK, 3 * CHUNK + 1])
def test_chunked_bit_exact_named_edges(store, assert_tables_equal, n):
    """Empty table, single row, exact chunk multiples, single-row tails."""
    o1, o2, chunked = _chunk_pair(store, n)
    assert_tables_equal(o1, o2)
    expected_chunks = 0 if n <= CHUNK else -(-n // CHUNK)
    assert chunked.stats.chunks_executed == expected_chunks


@pytest.mark.parametrize("spans", [
    [(0, 1)], [(5, 60), (70, 3)], [(0, 17), (17, 16), (33, 40), (500, 60)],
    [(100, 59), (100, 59), (599, 1), (0, 2), (300, 31)]])
def test_stacked_equals_sequential(store, assert_tables_equal, spans):
    service = PredictionService(store, jit=False)
    pi = store.get_table("patient_info")
    tables = [{"patient_info": _sub_table(pi, lo, lo + n)}
              for lo, n in spans]
    tickets = [service.submit(PROP_SQL, t) for t in tables]
    assert service.flush() == len(tickets)
    stacked = [t.result() for t in tickets]
    sequential = [service.run(PROP_SQL, t) for t in tables]
    for got, want in zip(stacked, sequential):
        assert_tables_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 32, 33, 65])
def test_bucketed_padded_bit_exact(store, assert_tables_equal, n):
    """A request of any row count served through the shape-bucketed path
    (pad to a pow-2 bucket, execute, trim) is bit-exact vs the same rows
    executed at their natural shape as a catalog table."""
    from repro_torch.core import OptimizerConfig
    from repro_torch.serve import AdmissionConfig, ManualClock
    rows = _sub_table(store.get_table("patient_info"), 0, n)
    opt = OptimizerConfig(enable_stats_pruning=False)
    ref_store = ModelStore(device="cpu")
    ref_store.register_table("patient_info", rows)
    ref_store.register_model("los_pi", store.get_model("los_pi"))
    want = PredictionService(ref_store, jit=False,
                             optimizer_config=opt).run(PROP_SQL)
    svc = PredictionService(
        store, jit=False, optimizer_config=opt, clock=ManualClock(),
        admission=AdmissionConfig(min_bucket_rows=16, background=False))
    ticket = svc.submit(PROP_SQL, {"patient_info": rows})
    assert svc.flush() == 1
    assert_tables_equal(ticket.result(timeout=0), want)


# ---------------------------------------------------------------------------
# Differential: the same call script through both packages' services
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jstore():
    """The JAX package's catalog over the same tables, with the same
    pipeline (the JAX fit is deterministic, so its digest equals the one
    carried into the port's store)."""
    from repro.core import ModelStore as JModelStore
    from repro.data import hospital_tables as jhospital
    js = JModelStore()
    for n, t in jhospital(N_ROWS, seed=7).items():
        js.register_table(n, t)
    pi = js.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    js.register_model("los_pi", _jax_pipeline(data))
    return js


def _same(jout, tout, rtol_cols=()):
    """Port answer vs JAX answer: tables column by column (dtype, shape,
    bits) and the validity mask, or bare arrays."""
    if not hasattr(jout, "columns"):
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        return
    assert sorted(tout.columns) == sorted(jout.columns)
    np.testing.assert_array_equal(tout.valid.numpy(), np.asarray(jout.valid))
    for name in jout.columns:
        want, got = np.asarray(jout.columns[name]), \
            tout.columns[name].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name in rtol_cols:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _service_script(svc, pi):
    """Cold then warm runs, a different query, coalesced override-table
    requests, identical catalog requests and a join (not row-local)."""
    outs = [svc.run(SQL), svc.run(SQL),
            svc.sql("SELECT pid, PREDICT(MODEL='los_pi') AS los "
                    "FROM patient_info")]
    parts = [(0, 100), (100, 350), (350, 600), (17, 18)]
    tickets = [svc.submit(SQL, {"patient_info": _sub_table(pi, lo, hi)})
               for lo, hi in parts]
    tickets += [svc.submit(SQL) for _ in range(3)]
    svc.flush()
    outs += [t.result(timeout=30) for t in tickets]
    outs.append(svc.run("SELECT pid, hematocrit FROM patient_info "
                        "JOIN blood_tests ON pid WHERE age > 30"))
    outs.append(svc.run(SQL, {"patient_info": _sub_table(pi, 0, 77)}))
    return outs


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("chunk_rows", [0, 128])
def test_service_script_matches_jax(store, jstore, jit, chunk_rows):
    from dataclasses import asdict

    from repro.serve import PredictionService as JService
    assert jstore.model_digest("los_pi") == store.model_digest("los_pi")
    jsvc = JService(jstore, jit=jit, chunk_rows=chunk_rows)
    tsvc = PredictionService(store, jit=jit, chunk_rows=chunk_rows)
    jouts = _service_script(jsvc, jstore.get_table("patient_info"))
    touts = _service_script(tsvc, store.get_table("patient_info"))
    if not jit:       # a jitted XLA plan may differ by an FMA ulp
        for jo, to in zip(jouts, touts):
            _same(jo, to)
    assert asdict(tsvc.stats) == asdict(jsvc.stats)
    # every ledger entry but the executable cache's bytes, which weigh the
    # plan's model constants: the port's trees also hold their tensors
    # staged on the device
    tinfo, jinfo = tsvc.cache_info(), jsvc.cache_info()
    assert tinfo.pop("bytes") > 0 and jinfo.pop("bytes") > 0
    assert tinfo == jinfo
    if jit:
        assert tsvc.stats.jit_traces > 0
    jsvc.close()
    tsvc.close()
