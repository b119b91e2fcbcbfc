"""End-to-end request tracing + unified metrics registry, on the port.
The cases of ``tests/test_telemetry.py`` run on the port's service
(pipelines fitted by the JAX package, carried across); a differential
script holds the port's traces (span names per request) and metrics
surface (the same ``repro_`` names and counter values) to the JAX
package's, and the sharded cases hold their spans' names, tracks and
placement attributes to the JAX service's on the same data.

Four layers of guarantees:

1. **Span mechanics are exact** (ManualClock, no threads): durations,
   nesting, worker ``add_span`` tracks, events, and the Chrome-trace
   export shape are pinned to deterministic clock readings.
2. **MetricsRegistry semantics**: counter/gauge/histogram keying by
   ``(name, labels)``, pull-time collectors sampled at read time, and
   Prometheus text rendering (TYPE lines, cumulative ``le`` buckets).
3. **Trace completeness per serving path**: cold compile, warm hit,
   coalesced groups and result-cache splice each leave their signature
   spans in the request's trace — the observability contract the
   EXPLAIN/trace tooling reads — sharded morsel waves and shuffle-exchange
   buckets included.  The port's own spans: ``lane_wait`` (a released
   group's wait for the execution lane), one ``op.<op>`` span per plan
   node under ``execute``, and the ``result_capture`` event on every
   execution of a capture-compiled plan.
4. **Off is free**: ``telemetry=False`` yields the shared NULL_TRACE
   (zero spans retained, ``ticket.trace()`` is None) and zero hot-path
   registry writes, while pull-time collectors keep working.

Plus the operator-level EXPLAIN ANALYZE contract: on an external-model
join query (known per-operator latency floor) the per-operator
measured times must sum to within 20% of the measured end-to-end wall
time.
"""

import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core import ExecutionConfig, ModelStore, OptimizerConfig
from repro_torch.core.ir import Plan
from repro_torch.data import hospital_tables
from repro.ml import (DecisionTree, LogisticRegression, Pipeline,
                      PipelineMetadata, StandardScaler)
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.relational.table import Table
from repro_torch.serve import (NULL_TRACE, AdmissionConfig, ManualClock,
                         MetricsRegistry, PredictionService, Trace,
                         chrome_trace)


def _carry(pipe):
    """A pipeline fitted by the JAX package, carried into the port as
    numpy state (the two packages' fits are not bitwise equal)."""
    return pipeline_from_state(pipeline_state(pipe))


pytestmark = pytest.mark.tier1

FEATS = ["age", "gender", "pregnant", "rcount"]
SQL = "SELECT pid, age FROM patient_info WHERE age > 30"
SQL_A = "SELECT pid, PREDICT(MODEL='m') AS score FROM patient_info"
SQL_B = "SELECT pid, age, PREDICT(MODEL='m') AS score FROM patient_info"
# Spans the port records and the JAX service does not.
PORT_ONLY = ("lane_wait", "result_capture")


def _shared(names):
    """Span names less the port's own (``PORT_ONLY`` and ``op.*``)."""
    return [n for n in names
            if n not in PORT_ONLY and not n.startswith("op.")]


def _jax_fit(store):
    pi = store.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    sc = StandardScaler(FEATS).fit(data)
    # depth 6: > inline_max_nodes, so the predict subtree stays cacheable
    pipe = Pipeline([sc], DecisionTree(task="regression", max_depth=6),
                    PipelineMetadata(name="m", task="regression"))
    pipe.fit({k: data[k] for k in FEATS}, data["length_of_stay"])
    return pipe


def _make_store(n_rows=300, seed=7):
    store = ModelStore(device="cpu")
    for n, t in hospital_tables(n_rows, seed=seed).items():
        store.register_table(n, t)
    store.register_model("m", _carry(_jax_fit(store)))
    return store


@pytest.fixture(scope="module")
def store():
    return _make_store()


def _sub(full: Table, lo: int, n: int) -> Table:
    """Rows ``[lo, lo + n)`` as a table of ``full``'s own package."""
    return type(full)({k: v[lo:lo + n] for k, v in full.columns.items()},
                      full.valid[lo:lo + n], full.schema)


# ---------------------------------------------------------------------------
# 1. Span mechanics (ManualClock — exact durations)
# ---------------------------------------------------------------------------

def test_span_durations_exact_on_manual_clock():
    clock = ManualClock()
    tr = Trace(clock, trace_id=7, name="q")
    with tr.span("parse"):
        clock.advance(0.25)
    with tr.span("execute", rows=10) as ex:
        clock.advance(1.5)
        with tr.span("inner"):
            clock.advance(0.5)
    clock.advance(0.125)
    tr.finish()
    tr.finish()                             # idempotent: first stamp wins

    parse, execute = tr.roots
    assert parse.duration == 0.25
    assert execute is ex and execute.duration == 2.0
    assert execute.attrs == {"rows": 10}
    (inner,) = execute.children
    assert inner.duration == 0.5
    assert tr.total_s == 2.375
    assert tr.span_names() == ["parse", "execute", "inner"]
    assert tr.find("inner").duration == 0.5
    assert "execute 2000.000ms" in tr.pretty()


def test_worker_add_span_and_events():
    clock = ManualClock()
    tr = Trace(clock)
    tr.event("cache", result="hit")
    with tr.span("execute"):
        # overlapping worker spans, recorded out-of-band with device tids
        tr.add_span("shard_wave", 0.0, 0.5, tid=1, device=0)
        tr.add_span("shard_wave", 0.0, 0.75, tid=2, device=1)
        clock.advance(0.75)
    ev = tr.find("cache")
    assert ev.duration == 0.0 and ev.attrs == {"result": "hit"}
    waves = [s for s in tr.spans() if s.name == "shard_wave"]
    assert [w.tid for w in waves] == [1, 2]
    # workers parent under the phase span that was open when they recorded
    assert all(w in tr.find("execute").children for w in waves)


def test_deferred_work_runs_when_the_trace_is_read():
    clock = ManualClock()
    tr = Trace(clock)
    with tr.span("execute") as ex:
        clock.advance(0.5)
    ready = {"now": False}

    def read_device():                  # e.g. CUDA events not yet passed
        if not ready["now"]:
            return False
        ex.attrs["device_ms"] = 400.0
        return True

    tr.defer(read_device)
    assert tr.find("execute").attrs == {}       # kept for the next read
    ready["now"] = True
    assert tr.find("execute").attrs == {"device_ms": 400.0}
    assert "device_ms=400.0" in tr.pretty()
    assert NULL_TRACE.defer(read_device) is None


def test_device_reader_reads_once_after_the_last_event():
    from repro_torch.core.codegen import _device_reader
    from repro_torch.serve.telemetry import Span

    class Event:                        # a CUDA event's reading surface
        def __init__(self, ms, passed=True):
            self.ms, self.passed = ms, passed

        def query(self):
            return self.passed

        def elapsed_time(self, end):
            return end.ms - self.ms

    spans = [Span("op.featurize", 0.0), Span("op.matmul_bias", 0.0)]
    marks = [Event(0.0), Event(2.5), Event(4.0, passed=False)]
    events, pool = list(marks), []
    read = _device_reader(spans, marks, pool)
    assert read() is False
    assert all("device_ms" not in s.attrs for s in spans)
    marks[-1].passed = True
    assert read() is True
    assert [s.attrs["device_ms"] for s in spans] == [2.5, 1.5]
    # the events go back to the pool, once
    assert marks == [] and pool == events
    assert read() is True and pool == events


def test_chrome_trace_export_shape(tmp_path):
    clock = ManualClock()
    tr = Trace(clock, trace_id=3, name="q1")
    with tr.span("execute", rows=4):
        clock.advance(0.5)
    tr.finish()
    path = tmp_path / "trace.json"
    doc = chrome_trace([tr], path=str(path))
    assert doc == json.loads(path.read_text())
    meta, span = doc["traceEvents"]
    assert meta["ph"] == "M" and meta["args"]["name"] == "q1 #3"
    assert span["ph"] == "X" and span["name"] == "execute"
    assert span["dur"] == 0.5e6 and span["args"] == {"rows": 4}


def test_null_trace_is_inert():
    with NULL_TRACE.span("anything", x=1) as s:
        assert s is None
    assert NULL_TRACE.event("e") is None
    assert NULL_TRACE.add_span("w", 0.0, 1.0) is None
    assert not NULL_TRACE.enabled
    assert NULL_TRACE.span_names() == []
    assert NULL_TRACE.to_chrome_events() == []


# ---------------------------------------------------------------------------
# 2. MetricsRegistry semantics
# ---------------------------------------------------------------------------

def test_registry_counters_gauges_labels():
    reg = MetricsRegistry()
    reg.inc("req_total")
    reg.inc("req_total", 2.0)
    reg.inc("req_total", labels={"tenant": "a"})
    reg.set_gauge("depth", 4)
    snap = reg.snapshot()
    assert snap["counters"]["req_total"] == 3.0
    assert snap["counters"]["req_total{tenant=a}"] == 1.0
    assert snap["gauges"]["depth"] == 4.0
    assert reg.writes == 4


def test_registry_histogram_render_cumulative():
    reg = MetricsRegistry()
    for v in (0.3, 0.4, 99.0):
        reg.observe("lat_seconds", v, buckets=(0.5, 1.0))
    text = reg.render()
    assert "# TYPE lat_seconds histogram" in text
    assert 'lat_seconds_bucket{le="0.5"} 2' in text
    assert 'lat_seconds_bucket{le="1"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_count 3" in text
    assert "lat_seconds_sum 99.7" in text


def test_registry_collectors_sampled_at_read_time():
    reg = MetricsRegistry()
    state = {"n": 1}
    unsub = reg.add_collector(
        lambda: [("live_total", "counter", state["n"], None),
                 ("live_depth", "gauge", 2.0, {"q": "x"})])
    assert reg.snapshot()["counters"]["live_total"] == 1.0
    state["n"] = 5
    snap = reg.snapshot()
    assert snap["counters"]["live_total"] == 5.0     # re-sampled, not cached
    assert snap["gauges"]["live_depth{q=x}"] == 2.0
    assert reg.writes == 0                           # collection is a read
    unsub()
    assert "live_total" not in reg.snapshot()["counters"]


# ---------------------------------------------------------------------------
# 3. Trace completeness per serving path
# ---------------------------------------------------------------------------

def test_queue_wait_span_is_exact_on_manual_clock(store):
    clock = ManualClock()
    svc = PredictionService(store, clock=clock, admission=AdmissionConfig(
        latency_budget_s=1.0, background=False))
    ticket = svc.submit(SQL)
    clock.advance(1.1)
    assert svc.admission_tick() == 1
    ticket.result(timeout=0)
    tr = ticket.trace()
    assert tr is not None and tr.finished is not None
    qw = tr.find("queue_wait")
    assert qw.duration == pytest.approx(1.1)
    assert qw.attrs["reason"] == "deadline"
    assert svc.traces()[-1] is tr
    svc.close()


def test_cold_then_warm_trace_spans(store):
    svc = PredictionService(store)
    svc.run(SQL)
    svc.run(SQL)
    cold, warm = svc.traces()
    assert cold.name == SQL
    for name in ("parse", "queue_wait", "optimize", "codegen", "execute"):
        assert cold.find(name) is not None, name
    assert cold.find("executable_cache").attrs["result"] == "miss"
    warm_names = warm.span_names()
    assert warm.find("executable_cache").attrs["result"] == "hit"
    assert "optimize" not in warm_names and "codegen" not in warm_names
    assert warm.find("execute") is not None
    svc.close()


def test_coalesced_member_gets_event_head_gets_execute(store):
    clock = ManualClock()
    svc = PredictionService(store, clock=clock, admission=AdmissionConfig(
        latency_budget_s=1.0, background=False))
    t1 = svc.submit(SQL)
    t2 = svc.submit(SQL)
    clock.advance(1.5)
    assert svc.admission_tick() == 2
    head, rider = t1.trace(), t2.trace()
    assert head.find("execute").attrs["coalesced"] == 1
    assert rider.find("coalesced").attrs["group"] == 2
    assert rider.find("execute") is None
    assert len(svc.traces()) == 2
    svc.close()


def test_splice_trace_visible_in_second_query(store):
    svc = PredictionService(store)
    svc.run(SQL_A)
    svc.run(SQL_B)
    assert svc.stats.spliced_executions == 1
    first, second = svc.traces()
    assert first.find("result_cache_splice") is None
    splice = second.find("result_cache_splice")
    assert splice is not None and splice.attrs["hit"] is True
    assert "patient_info" in splice.attrs["subtree"]
    svc.close()


def test_lane_wait_span_is_exact_while_the_lane_is_held(store):
    clock = ManualClock()
    svc = PredictionService(store, clock=clock, admission=AdmissionConfig(
        latency_budget_s=1.0, background=False))
    ticket = svc.submit(SQL)
    flusher = threading.Thread(target=svc.flush, daemon=True)
    with svc._flush_lock:
        flusher.start()
        # queue_wait is recorded at the group's release, before the lane
        give_up = time.monotonic() + 30.0
        while ticket.trace().find("queue_wait") is None:
            assert time.monotonic() < give_up, "flush never released it"
            time.sleep(0.001)
        clock.advance(0.75)
    flusher.join(timeout=30.0)
    assert not flusher.is_alive()
    ticket.result(timeout=0)
    tr = ticket.trace()
    lane = tr.find("lane_wait")
    assert lane.duration == 0.75
    assert lane.start == tr.find("queue_wait").end
    # drained by another thread's flush, not by its submitter
    assert lane.attrs == {"own_flush": False}
    assert lane in tr.roots and lane.end <= tr.find("execute").start
    svc.run(SQL)                       # submitted and flushed here
    assert svc.traces()[-1].find("lane_wait").attrs["own_flush"] is True
    svc.close()


@pytest.mark.parametrize("path", ["whole", "chunked", "stacked"])
def test_one_op_span_per_plan_node_under_execute(store, path):
    svc = PredictionService(store, chunk_rows=128 if path == "chunked"
                            else 0)
    tables = None
    if path == "stacked":
        tables = {"patient_info": _sub(store.get_table("patient_info"),
                                       0, 40)}
    svc.run(SQL_A, tables)
    (tr,) = svc.traces()
    ex = tr.find("execute")
    plan = svc.explain(SQL_A, tables).plan
    order = [(f"op.{plan.nodes[nid].op}", nid) for nid in plan.topo_order()]
    calls = 3 if path == "chunked" else 1       # 300 rows in 128-row chunks
    ops = [(s.name, s.attrs["nid"]) for s in ex.children
           if s.name.startswith("op.")]
    assert ops == order * calls
    assert len([s for s in tr.spans() if s.name.startswith("op.")]) \
        == len(ops)
    # on the CPU there is no stream to time
    assert all("device_ms" not in s.attrs for s in tr.spans())
    svc.close()


def test_result_capture_marks_residency_puts_and_evictions(store):
    svc = PredictionService(store)
    svc.run(SQL_A)                     # captures its scored subtree
    svc.run(SQL_A)                     # the same capture, now resident
    svc.run(SQL_B)                     # spliced from the cache
    first, second, spliced = svc.traces()
    assert first.find("result_capture").attrs == {
        "resident": False, "put": True, "evicted": 0}
    assert first.find("result_capture") in first.find("execute").children
    assert second.find("result_capture").attrs == {
        "resident": True, "put": False, "evicted": 0}
    assert spliced.find("result_cache_splice") is not None
    assert spliced.find("result_capture") is None
    svc.close()
    # no room for a capture: each put evicts the value it put
    svc = PredictionService(store, result_cache_bytes=1)
    for _ in range(3):
        svc.run(SQL_A)
    assert [tr.find("result_capture").attrs for tr in svc.traces()] == [
        {"resident": False, "put": True, "evicted": 1}] * 3
    assert (svc.stats.result_puts, svc.stats.result_evictions,
            svc.stats.spliced_executions) == (3, 3, 0)
    svc.close()


def _sharded_trace_run(pkg):
    """One sharded scan with zone-map pruning, served by ``pkg``'s
    service: its stats and its trace's ``shard_wave`` spans."""
    if pkg == "jax":
        from repro.core import ExecutionConfig as XConfig
        from repro.core import ModelStore as XStore
        from repro.relational.table import Table as XTable
        from repro.serve import PredictionService as XService
        kw = {}
    else:
        XConfig, XStore, XTable, XService = (ExecutionConfig, ModelStore,
                                             Table, PredictionService)
        kw = {"device": "cpu"}
    rng = np.random.RandomState(0)
    n = 1200
    t = XTable.from_pydict({
        "pid": np.arange(n),
        "age": np.sort(rng.randint(0, 100, n)).astype(np.int32)})
    store = XStore(**kw)
    store.register_table("people", t, partition_rows=200)
    svc = XService(store, execution_config=XConfig(
        sharded=True, shard_min_bucket_rows=32))
    svc.run("SELECT pid FROM people WHERE age < 30")
    (tr,) = svc.traces()
    waves = [(s.name, s.tid, dict(s.attrs)) for s in tr.spans()
             if s.name == "shard_wave"]
    stats = (svc.stats.sharded_executions, svc.stats.partitions_scanned,
             svc.stats.shard_waves)
    names = _shared(tr.span_names())
    svc.close()
    return stats, waves, names


def test_sharded_trace_carries_shard_waves():
    (executions, scanned, n_waves), waves, names = \
        _sharded_trace_run("torch")
    assert executions == 1
    assert waves and all(tid >= 1 for _n, tid, _a in waves)
    assert sum(a["partitions"] for _n, _t, a in waves) == scanned
    # the same spans, tracks and attributes as the JAX service's trace
    assert _sharded_trace_run("jax") == ((executions, scanned, n_waves),
                                         waves, names)


def _exchange_store(n_pids=48, per_pid=4, seed=3, pkg="torch"):
    """Fact/dim pair partitioned on *different* keys, so the join can only
    shard through the hash-repartition exchange (test_exchange idiom);
    ``pkg="jax"`` builds the same store in the JAX package."""
    if pkg == "jax":
        from repro.core import ModelStore as XStore
        from repro.relational.table import Table as XTable
        kw = {}
    else:
        XStore, XTable, kw = ModelStore, Table, {"device": "cpu"}
    rng = np.random.RandomState(seed)
    n_rows = n_pids * per_pid
    visits = XTable.from_pydict({
        "oid": np.arange(n_rows, dtype=np.int64),
        "pid": rng.permutation(np.repeat(
            np.arange(n_pids, dtype=np.int32), per_pid)),
        "amount": rng.uniform(0.0, 9.0, n_rows).astype(np.float32)})
    patients = XTable.from_pydict({
        "pid": np.arange(n_pids, dtype=np.int32),
        "age": rng.uniform(0.0, 99.0, n_pids).astype(np.float32)})
    store = XStore(**kw)
    store.register_table("visits", visits, partition_by="oid",
                         partition_bounds=[n_rows // 2])
    store.register_table("patients", patients, partition_by="pid",
                         partition_bounds=[n_pids // 2])
    return store


def _join_plan(plan_cls=Plan):
    plan = plan_cls()
    v = plan.emit("scan", "RA", [], "table", table="visits")
    p = plan.emit("scan", "RA", [], "table", table="patients")
    plan.output = plan.emit("join", "RA", [v, p], "table", on="pid",
                            how="inner")
    return plan


def _exchange_trace_run(pkg):
    if pkg == "jax":
        from repro.core import ExecutionConfig as XConfig
        from repro.core.ir import Plan as XPlan
        from repro.serve import PredictionService as XService
    else:
        XConfig, XPlan, XService = ExecutionConfig, Plan, PredictionService
    svc = XService(_exchange_store(pkg=pkg), execution_config=XConfig(
        sharded=True, shard_min_bucket_rows=4, shard_morsel_rows=16,
        shard_exchange_cost_gate=False))
    svc.run(_join_plan(XPlan))
    (tr,) = svc.traces()
    spans = [(s.name, s.tid, dict(s.attrs)) for s in tr.spans()
             if s.name.startswith("exchange_")]
    out = (svc.stats.exchange_executions, svc.stats.exchange_bytes_moved,
           tr.find("exchange_build").attrs, spans, _shared(tr.span_names()))
    svc.close()
    return out


def test_exchange_trace_spans_and_placement_attrs():
    executions, moved, build, spans, names = _exchange_trace_run("torch")
    assert executions == 1 and moved > 0
    assert build["on"] == "pid"
    assert build["n_buckets"] >= 1          # ExchangePlacement.describe
    assert build["anchor_rows_total"] == 192
    buckets = [s for s in spans if s[0] == "exchange_bucket"]
    assert buckets and all(tid >= 1 for _n, tid, _a in buckets)
    scatter = [a for n, _t, a in spans if n == "exchange_scatter"]
    assert scatter and scatter[0]["rows"] == 192
    # the same shuffle, spans and bytes as the JAX service's
    assert _exchange_trace_run("jax") == (executions, moved, build, spans,
                                          names)


def test_export_traces_writes_chrome_json(store, tmp_path):
    svc = PredictionService(store)
    svc.run(SQL)
    path = tmp_path / "traces.json"
    doc = svc.export_traces(str(path))
    assert path.exists()
    names = {e["name"] for e in doc["traceEvents"]}
    assert "execute" in names and "process_name" in names
    svc.close()


def test_trace_ring_capacity_bounds_retention(store):
    svc = PredictionService(store, trace_capacity=2)
    for _ in range(5):
        svc.run(SQL)
    assert len(svc.traces()) == 2
    assert len(svc.traces(1)) == 1
    svc.close()


# ---------------------------------------------------------------------------
# 4. telemetry=False is free
# ---------------------------------------------------------------------------

def test_telemetry_off_zero_spans_zero_writes(store):
    svc = PredictionService(store, telemetry=False)
    ticket = svc.submit(SQL)
    flusher = threading.Thread(target=svc.flush, daemon=True)
    flusher.start()
    flusher.join(timeout=30.0)
    assert not flusher.is_alive()
    ticket.result(timeout=5)
    svc.run(SQL)
    svc.run(SQL_A)                                # a capture-compiled plan
    svc.run(SQL_A)
    assert svc.traces() == []
    assert ticket.trace() is None
    assert svc.metrics.writes == 0                # no hot-path mutations
    # pull-time collectors still work: stats stay the source of truth
    snap = svc.metrics_snapshot()
    assert snap["counters"]["repro_submitted_total"] == 4.0
    assert snap["counters"]["repro_cache_hits_total"] == 2.0
    svc.close()


def test_telemetry_on_writes_and_prometheus_text(store):
    svc = PredictionService(store)
    svc.run(SQL)
    assert svc.metrics.writes >= 3      # queue wait + exec + compile observes
    text = svc.metrics_text()
    assert "# TYPE repro_queue_wait_seconds histogram" in text
    assert "repro_exec_seconds_count 1" in text
    assert "repro_compile_seconds_count 1" in text
    assert "repro_plans_compiled_total 1" in text
    assert "repro_batch_executions_total 1" in text
    assert "repro_admission_queue_depth_high_water 1" in text
    svc.close()


# ---------------------------------------------------------------------------
# 5. EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

EXTERNAL_LATENCY_S = 20e-3


def _explain_store(n_pids=64, per_pid=4, seed=11):
    """Shuffle-join-shaped store with an *external*-flavor model: every
    operator above the scans costs real wall time (the external hop has a
    simulated 20ms floor), so per-operator times must account for the
    end-to-end measurement."""
    rng = np.random.RandomState(seed)
    store = _exchange_store(n_pids=n_pids, per_pid=per_pid, seed=seed)
    visits = store.get_table("visits")
    patients = store.get_table("patients")
    age = np.asarray(patients.column("age"))
    feats = ["age", "amount"]
    data = {"age": age[np.asarray(visits.column("pid"))],
            "amount": np.asarray(visits.column("amount"))}
    y = (data["age"] * 0.02 + data["amount"] * 0.1
         + rng.randn(len(data["age"])) > 1.0).astype(np.int32)
    sc = StandardScaler(feats).fit(data)
    pipe = Pipeline([sc], LogisticRegression(steps=25),
                    PipelineMetadata(name="risk", task="classification",
                                     flavor="external"))
    pipe.fit(data, y)
    pipe = _carry(pipe)
    store.register_model("risk", pipe)
    return store, pipe


def _predict_join_plan(pipe):
    plan = _join_plan()
    j = plan.output
    f = plan.emit("featurize", "MLD", [j], "matrix", pipeline_name="risk",
                  featurizers=pipe.featurizers,
                  input_columns=pipe.input_columns())
    m = plan.emit("predict_model", "MLD", [f], "matrix", model=pipe.model,
                  model_name="risk", proba=True, task="classification",
                  flavor="external")
    plan.output = plan.emit("attach_column", "RA", [j, m], "table", name="p")
    return plan


def test_explain_analyze_operator_times_account_for_e2e():
    store, pipe = _explain_store()
    svc = PredictionService(
        store,
        optimizer_config=OptimizerConfig(enable_model_inlining=False,
                                         enable_nn_translation=False),
        execution_config=ExecutionConfig(
            external_latency_s=EXTERNAL_LATENCY_S))
    ex = svc.explain(_predict_join_plan(pipe), analyze=True)
    assert ex.analyze and ex.total_s > 0
    op_names = [n.op for _, n in ex.operators()]
    assert "join" in op_names and "predict_model" in op_names
    measured = ex.measured_s
    # the acceptance bound: per-operator sum within 20% of end-to-end
    assert measured == pytest.approx(ex.total_s, rel=0.2)
    # the external hop's 20ms floor is visible on its operator
    pm = [nid for nid, n in ex.plan.nodes.items()
          if n.op == "predict_model"]
    assert pm and ex.samples[pm[0]][0] >= EXTERNAL_LATENCY_S * 0.5
    text = ex.pretty()
    assert "predict_model" in text and "actual time=" in text
    assert "end-to-end" in text
    svc.close()


def test_explain_without_analyze_renders_plan_only(store):
    svc = PredictionService(store)
    ex = svc.explain(SQL)
    assert not ex.analyze and ex.samples == {}
    text = ex.pretty()
    assert "scan [patient_info]" in text
    assert "actual time=" not in text
    svc.close()


# ---------------------------------------------------------------------------
# Differential: traces and the metrics surface against the JAX package
# ---------------------------------------------------------------------------

def _telemetry_script(svc, clock, full):
    svc.run(SQL)                                   # cold
    svc.run(SQL)                                   # warm
    svc.run(SQL_A)                                 # capture
    svc.run(SQL_B)                                 # splice
    tickets = [svc.submit(SQL_A, {"patient_info": _sub(full, lo, n)})
               for lo, n in ((0, 10), (10, 30), (50, 7))]
    clock.advance(2.0)
    svc.admission_tick()
    for t in tickets:
        t.result(timeout=0)
    svc.session(tenant="acme").sql(SQL)
    bad = svc.submit("SELECT pid FROM nowhere")
    svc.flush()
    return [tr.span_names() for tr in svc.traces()], bad.trace() \
        is not None, svc.metrics_snapshot()


def test_traces_and_metrics_match_jax(store):
    from repro.core import ModelStore as JModelStore
    from repro.data import hospital_tables as jhospital
    from repro.serve import AdmissionConfig as JAdmissionConfig
    from repro.serve import ManualClock as JManualClock
    from repro.serve import PredictionService as JService
    js = JModelStore()
    for n, t in jhospital(300, seed=7).items():
        js.register_table(n, t)
    js.register_model("m", _jax_fit(js))
    assert js.model_digest("m") == store.model_digest("m")
    cfg = dict(latency_budget_s=1.0, background=False)
    jclock, tclock = JManualClock(), ManualClock()
    jsvc = JService(js, clock=jclock, admission=JAdmissionConfig(**cfg))
    tsvc = PredictionService(store, clock=tclock,
                             admission=AdmissionConfig(**cfg))
    jspans, jbad, jsnap = _telemetry_script(
        jsvc, jclock, js.get_table("patient_info"))
    tspans, tbad, tsnap = _telemetry_script(
        tsvc, tclock, store.get_table("patient_info"))
    # the port's own spans aside, the same spans per request
    assert [_shared(names) for names in tspans] == jspans and tbad and jbad
    assert any("result_cache_splice" in names for names in tspans)
    # and the port's own where the script makes them: a lane wait for
    # every released request, operator spans in every execution, a
    # capture event on the one whole-table capture (SQL_A's first run)
    for names in tspans:
        assert ("lane_wait" in names) == ("queue_wait" in names)
        assert any(n.startswith("op.") for n in names) == \
            ("execute" in names)
    assert [i for i, names in enumerate(tspans)
            if "result_capture" in names] == [2]
    assert tsnap["counters"] == jsnap["counters"]
    assert tsnap["counters"]["repro_jit_traces_total"] > 0
    # the executable tier's bytes weigh plan constants, which the port
    # holds differently (its trees also keep their device tensors)
    for snap in (tsnap, jsnap):
        assert snap["gauges"].pop("repro_exec_cache_bytes") > 0
    assert tsnap["gauges"] == jsnap["gauges"]
    assert {k: h["count"] for k, h in tsnap["histograms"].items()} == \
        {k: h["count"] for k, h in jsnap["histograms"].items()}
    lines = {ln.split(" ")[0] for ln in tsvc.metrics_text().splitlines()}
    assert lines == {ln.split(" ")[0]
                     for ln in jsvc.metrics_text().splitlines()}
    jsvc.close()
    tsvc.close()
