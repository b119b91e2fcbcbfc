"""Continuous-batching admission loop + shape-bucketed executables, on
the port.  The cases of ``tests/test_continuous_batching.py`` run on the
port's service (pipeline fitted by the JAX package, carried across), and a
differential script drives both packages' services through the same
fake-clock admission sequence: tickets bitwise equal to the JAX service's
with ``jit=False``, and ``ServiceStats`` and ``admission_info()`` equal
field by field — with ``jit=True`` for ``jit_traces`` and bucket counts.

Four layers of guarantees:

1. **Deterministic admission semantics** (fake clock, no threads, no
   sleeps): a group flushes exactly when its oldest request's latency
   budget expires or it reaches ``max_batch_requests``; the admit/flush
   event hooks observe every transition; backpressure rejects over-bound
   submits.
2. **Bucketed-padded execution is bit-exact** vs natural-shape execution
   for row counts covering 0, 1, bucket boundaries and boundaries±1.
3. **Bounded compiles**: varying batch sizes hit O(log max_batch) compiled
   executables — signature misses and shape-driven (bucket) compiles are
   split counters, and actual jit traces match the bucket count.
4. **Background loop** (real clock, timeout-guarded): ledger invariants
   hold under multi-thread load, ``close()`` drains in-flight requests
   without deadlock, and ``PredictionTicket.result(timeout=...)`` still
   raises ``TimeoutError`` while the loop is running.
"""

import threading

import numpy as np
import pytest

from repro_torch.core import ModelStore, OptimizerConfig
from repro_torch.core import codegen
from repro_torch.data import hospital_tables
from repro.ml import DecisionTree, Pipeline, PipelineMetadata, StandardScaler
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.relational.table import Table
from repro_torch.serve import (AdmissionConfig, AdmissionQueueFull, ManualClock,
                         PredictionService)


def _carry(pipe):
    """A pipeline fitted by the JAX package, carried into the port as
    numpy state (the two packages' fits are not bitwise equal)."""
    return pipeline_from_state(pipeline_state(pipe))


pytestmark = pytest.mark.tier1

N_ROWS = 400
FEATS = ["age", "gender", "pregnant", "rcount"]
SQL = "SELECT pid, PREDICT(MODEL='m') AS p FROM patient_info WHERE age > 30"
BUCKET = 8          # min_bucket_rows used throughout: boundaries at 8, 16...


def _jax_fit(full):
    data = {c: np.asarray(full.column(c)) for c in full.names}
    sc = StandardScaler(FEATS).fit(data)
    pipe = Pipeline([sc], DecisionTree(task="regression", max_depth=5),
                    PipelineMetadata(name="m", task="regression"))
    pipe.fit({k: data[k] for k in FEATS}, data["length_of_stay"])
    return pipe


@pytest.fixture(scope="module")
def base():
    full = hospital_tables(N_ROWS, seed=7)["patient_info"]
    pipe = _carry(_jax_fit(full))
    store = ModelStore(device="cpu")
    store.register_table("patient_info", full)
    store.register_model("m", pipe)
    return store, full, pipe


def _sub(full: Table, lo: int, n: int) -> Table:
    """Rows ``[lo, lo + n)`` as a table of ``full``'s own package."""
    return type(full)({k: v[lo:lo + n] for k, v in full.columns.items()},
                      full.valid[lo:lo + n], full.schema)


def _manual_service(store, clock, jit=False, **cfg):
    defaults = dict(latency_budget_s=1.0, min_bucket_rows=BUCKET,
                    background=False)
    defaults.update(cfg)
    return PredictionService(store, jit=jit, clock=clock,
                             admission=AdmissionConfig(**defaults))


# ---------------------------------------------------------------------------
# 1. Deterministic admission semantics (fake clock, no threads)
# ---------------------------------------------------------------------------

def test_deadline_flush_with_fake_clock(base):
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock)
    t1 = svc.submit(SQL, {"patient_info": _sub(full, 0, 20)})
    assert svc.admission_tick() == 0          # budget not yet expired
    clock.advance(0.5)
    assert svc.admission_tick() == 0          # still inside the budget
    t2 = svc.submit(SQL, {"patient_info": _sub(full, 20, 30)})
    clock.advance(0.6)                        # oldest is now 1.1s old
    assert svc.admission_tick() == 2          # one coalesced flush
    assert t1.result(timeout=0).capacity == 20
    assert t2.result(timeout=0).capacity == 30
    assert svc.stats.deadline_flushes == 1
    assert svc.stats.batch_executions == 1
    assert svc.stats.coalesced_requests == 1


def test_younger_request_does_not_extend_oldest_deadline(base):
    """The flush deadline belongs to the *oldest* request in the group —
    late arrivals ride along, they never push the deadline out."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock)
    svc.submit(SQL, {"patient_info": _sub(full, 0, 10)})
    clock.advance(0.99)
    svc.submit(SQL, {"patient_info": _sub(full, 10, 10)})   # 0.99s younger
    clock.advance(0.02)                       # oldest expired, younger not
    assert svc.admission_tick() == 2          # flushed together regardless
    assert svc.stats.deadline_flushes == 1


def test_full_group_flushes_without_deadline(base):
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, max_batch_requests=3)
    tickets = [svc.submit(SQL, {"patient_info": _sub(full, 10 * i, 10)})
               for i in range(3)]
    assert svc.admission_tick() == 3          # no clock advance needed
    assert svc.stats.size_flushes == 1
    assert svc.stats.deadline_flushes == 0
    for i, t in enumerate(tickets):
        assert t.result(timeout=0).capacity == 10


def test_admit_and_flush_event_hooks(base):
    """The Batcher's event seam: every admission and every group release
    (with its reason) is observable synchronously — the contract the
    deterministic harness rests on."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, max_batch_requests=2)
    admitted, flushed = [], []
    svc.batcher.on_admit = admitted.append
    svc.batcher.on_flush = \
        lambda key, items, reason: flushed.append((len(items), reason))
    svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    assert len(admitted) == 1 and not flushed
    svc.submit(SQL, {"patient_info": _sub(full, 5, 5)})     # group now full
    assert svc.admission_tick() == 2
    assert flushed == [(2, "full")]
    svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    clock.advance(1.5)
    svc.admission_tick()
    assert flushed[-1] == (1, "deadline")
    svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    svc.flush()
    assert flushed[-1] == (1, "drain")
    assert len(admitted) == 4


def test_backpressure_rejects_over_bound(base):
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, max_queue=2, block_on_full=False)
    svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    svc.submit(SQL, {"patient_info": _sub(full, 5, 5)})
    with pytest.raises(AdmissionQueueFull):
        svc.submit(SQL, {"patient_info": _sub(full, 10, 5)})
    assert svc.stats.queue_rejections == 1
    assert svc.flush() == 2                   # bounded work still serves
    # space freed: admission works again
    t = svc.submit(SQL, {"patient_info": _sub(full, 10, 5)})
    svc.flush()
    assert t.result(timeout=0).capacity == 5


def test_blocking_offer_times_out_on_wall_clock(base):
    """A full queue with block_on_full=True must raise after the wall-time
    offer timeout even under a ManualClock that never advances — the fake
    clock drives deadlines, never how long a producer really blocks."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, max_queue=1, block_on_full=True,
                          offer_timeout_s=0.05)
    svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    with pytest.raises(AdmissionQueueFull):
        svc.submit(SQL, {"patient_info": _sub(full, 5, 5)})
    assert svc.flush() == 1


def test_legacy_mode_queue_effectively_unbounded(base):
    """Regression: without an admission config, the explicit-flush contract holds —
    a single thread may queue arbitrarily many requests before its own
    flush() (only that thread could ever drain the queue, so any real
    bound would deadlock-then-reject it)."""
    store, full, _ = base
    svc = PredictionService(store, jit=False)
    assert svc.batcher.config.max_queue >= 1 << 32
    tickets = [svc.submit(SQL, {"patient_info": _sub(full, 0, 4)})
               for _ in range(40)]
    assert svc.flush() == 40
    assert all(t.done for t in tickets)


def test_queue_latency_percentiles_from_fake_clock(base):
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock)
    svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    clock.advance(0.2)
    svc.submit(SQL, {"patient_info": _sub(full, 5, 5)})
    clock.advance(0.9)                        # waits: 1.1s and 0.9s
    svc.admission_tick()
    info = svc.admission_info()
    assert info["queue_p50_ms"] == pytest.approx(900.0)
    assert info["queue_p95_ms"] == pytest.approx(1100.0)
    assert info["coalesce_rate"] == pytest.approx(0.5)


def test_adaptive_budget_shrinks_under_light_load(base):
    """SLO-aware flush window: with one lone request (queue-depth EWMA of
    1 against a 64-request batch cap) the effective budget sits just above
    the configured *minimum* — the request is served almost immediately
    where the fixed 1s budget would have parked it."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, adaptive_latency=True,
                          min_latency_budget_s=0.01,
                          max_latency_budget_s=0.65,
                          adaptive_alpha=1.0, max_batch_requests=64)
    assert svc.admission_info()["latency_budget_s"] == \
        pytest.approx(0.01)                       # idle: min budget
    svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    budget = svc.admission_info()["latency_budget_s"]
    assert budget == pytest.approx(0.01 + 0.64 / 64)
    clock.advance(0.005)
    assert svc.admission_tick() == 0              # inside even the min
    clock.advance(0.03)                           # past the shrunk window
    assert svc.admission_tick() == 1
    assert svc.stats.deadline_flushes == 1


def test_adaptive_budget_grows_as_queue_deepens(base):
    """A deepening queue slides the window toward the max budget: the
    same elapsed wait that flushes under light load keeps coalescing
    under heavy load."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, adaptive_latency=True,
                          min_latency_budget_s=0.01,
                          max_latency_budget_s=0.65,
                          adaptive_alpha=1.0, max_batch_requests=16)
    for i in range(8):                            # EWMA(alpha=1) -> depth 8
        svc.submit(SQL, {"patient_info": _sub(full, 5 * i, 5)})
    info = svc.admission_info()
    assert info["queue_depth_ewma"] == pytest.approx(8.0)
    assert info["latency_budget_s"] == pytest.approx(0.01 + 0.64 * 0.5)
    clock.advance(0.05)                           # light-load flush point
    assert svc.admission_tick() == 0              # still coalescing
    clock.advance(0.30)
    assert svc.admission_tick() == 8              # grown window expired
    assert svc.stats.deadline_flushes == 1
    # queue drained: the EWMA decays toward idle and the window shrinks
    assert svc.admission_info()["latency_budget_s"] < 0.33


def test_adaptive_window_inverted_raises(base):
    store, _, _ = base
    with pytest.raises(ValueError):
        _manual_service(store, ManualClock(), adaptive_latency=True,
                        min_latency_budget_s=0.5, max_latency_budget_s=0.1)


# ---------------------------------------------------------------------------
# 2. Bucketed-padded execution is bit-exact vs natural-shape execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, BUCKET - 1, BUCKET, BUCKET + 1,
                               2 * BUCKET, 2 * BUCKET + 1, 4 * BUCKET - 1])
def test_bucketed_bit_exact_vs_natural_shape(base, assert_tables_equal, n):
    """An n-row request served through pad-to-bucket + trim equals the same
    rows served at their natural shape (as a catalog table), including
    n=0, n=1, exact bucket boundaries, and boundaries±1.

    Deliberate mirror of the hypothesis property
    ``test_serving_properties.test_bucketed_padded_bit_exact`` (random row
    counts): hypothesis is an optional dependency, so that whole module
    importorskips away on minimal installs — these named edges keep the
    bucketing contract exercised everywhere.  Change both together."""
    store_full, full, pipe = base
    rows = _sub(full, 0, n)
    # natural-shape reference: the rows ARE the catalog table, so the
    # catalog path executes them unpadded
    ref_store = ModelStore(device="cpu")
    ref_store.register_table("patient_info", rows)
    ref_store.register_model("m", pipe)
    opt = OptimizerConfig(enable_stats_pruning=False)
    want = PredictionService(ref_store, jit=False,
                             optimizer_config=opt).run(SQL)

    clock = ManualClock()
    svc = _manual_service(store_full, clock, jit=False)
    svc.optimizer_config = opt
    got = svc.submit(SQL, {"patient_info": rows})
    svc.flush()
    assert_tables_equal(got.result(timeout=0), want)


def test_stacked_group_bit_exact_and_coalesced(base, assert_tables_equal):
    """A coalesced group spanning several sizes splits back to per-request
    results identical to serving each request alone."""
    store, full, _ = base
    spans = [(0, 1), (1, BUCKET), (9, BUCKET + 3), (30, 2 * BUCKET + 1)]
    clock = ManualClock()
    svc = _manual_service(store, clock)
    tickets = [svc.submit(SQL, {"patient_info": _sub(full, lo, n)})
               for lo, n in spans]
    clock.advance(2.0)
    assert svc.admission_tick() == len(spans)
    assert svc.stats.batch_executions == 1
    assert svc.stats.coalesced_requests == len(spans) - 1
    solo = PredictionService(store, jit=False)
    for t, (lo, n) in zip(tickets, spans):
        want = solo.run(SQL, {"patient_info": _sub(full, lo, n)})
        assert_tables_equal(t.result(timeout=0), want)


# ---------------------------------------------------------------------------
# 3. Bounded compiles: signature misses vs shape recompiles are split
# ---------------------------------------------------------------------------

def test_compiles_bounded_by_bucket_count(base):
    """Regression for the conflated executable-cache stats: batch-size
    driven recompiles must count as ``bucket_compiles`` (bounded by the
    number of pow-2 buckets), never inflate signature ``cache_misses`` —
    and actual jit traces must equal the bucket count, proving padding
    really holds shapes to O(log max_batch)."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, jit=True)     # traces are the point
    codegen.reset_compile_stats()
    sizes = [1, 2, 3, 5, 7, 8, 9, 12, 15, 16, 17, 25, 31, 32, 33]
    for n in sizes:
        t = svc.submit(SQL, {"patient_info": _sub(full, 0, n)})
        svc.flush()
        t.result(timeout=0)
    buckets = {max(BUCKET, 1 << (int(n) - 1).bit_length()) for n in sizes}
    assert svc.stats.cache_misses == 1                # one signature, once
    assert svc.stats.bucket_compiles == len(buckets)  # 8, 16, 32, 64
    assert svc.stats.bucket_hits == len(sizes) - len(buckets)
    assert svc.stats.jit_traces == len(buckets)
    assert codegen.compile_stats["jit_traces"] == len(buckets)
    # repeat sweep: all warm — zero new compiles of any kind
    for n in sizes:
        t = svc.submit(SQL, {"patient_info": _sub(full, 0, n)})
        svc.flush()
        t.result(timeout=0)
    assert svc.stats.cache_misses == 1
    assert svc.stats.bucket_compiles == len(buckets)
    assert svc.stats.jit_traces == len(buckets)
    info = svc.admission_info()
    assert info["bucket_hit_rate"] == pytest.approx(
        1 - len(buckets) / (2 * len(sizes)))


def test_bucket_lookups_stay_out_of_signature_counters(base):
    """The CostAwareCache-level half of the split: bucket lookups use
    ``count=False``, so the executable cache's hit/miss ledger keeps
    meaning 'signature reuse'."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock)
    for n in (3, 9, 20, 3, 9, 20):
        t = svc.submit(SQL, {"patient_info": _sub(full, 0, n)})
        svc.flush()
        t.result(timeout=0)
    # cache-level: 1 signature miss + 5 signature hits; bucket lookups
    # (3 misses + 3 hits at the bucket layer) must not appear here
    assert svc._exec_cache.misses == 1
    assert svc._exec_cache.hits == 5
    assert svc.stats.bucket_compiles == 3
    assert svc.stats.bucket_hits == 3


def test_oversize_group_releases_in_capped_chunks(base):
    """max_batch_requests bounds *execution* batch size, not just flush
    timing: a burst that accumulated behind a slow execution must split
    into capped chunks, never stack as one giant padded batch."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, max_batch_requests=4)
    tickets = [svc.submit(SQL, {"patient_info": _sub(full, 3 * i, 3)})
               for i in range(10)]
    clock.advance(2.0)
    assert svc.admission_tick() == 10
    assert svc.stats.batch_executions == 3          # ceil(10 / 4)
    assert svc.stats.coalesced_requests == 7
    for i, t in enumerate(tickets):
        assert t.result(timeout=0).capacity == 3


def test_full_release_holds_subcap_tail_until_its_deadline(base):
    """Tail policy: a cap-overflowing group's "full" release pops whole
    cap-sized chunks only — the sub-cap tail (the *newest* requests) stays
    queued to coalesce with the next burst instead of executing a
    near-empty padded batch.  The tail still honors its own latency
    budget, and later admissions can complete it into a full chunk."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, max_batch_requests=4)
    tickets = [svc.submit(SQL, {"patient_info": _sub(full, 3 * i, 3)})
               for i in range(6)]
    # full trigger at t=0: one capped chunk of 4 releases, tail of 2 holds
    assert svc.admission_tick() == 4
    assert svc.stats.size_flushes == 1
    assert all(t.done for t in tickets[:4])
    assert not any(t.done for t in tickets[4:])
    # not due yet: the tail keeps waiting inside its own budget
    clock.advance(0.5)
    assert svc.admission_tick() == 0
    # two more arrivals complete the tail into a full chunk -> releases
    tickets += [svc.submit(SQL, {"patient_info": _sub(full, 0, 3)})
                for _ in range(2)]
    assert svc.admission_tick() == 4
    assert svc.stats.size_flushes == 2
    assert all(t.done for t in tickets)
    # a tail nothing completes releases at its own deadline instead
    tail = [svc.submit(SQL, {"patient_info": _sub(full, 0, 3)})
            for _ in range(5)]
    assert svc.admission_tick() == 4                # full chunk, 1 held
    assert not tail[4].done
    clock.advance(1.0)                              # tail's budget expires
    assert svc.admission_tick() == 1
    assert svc.stats.deadline_flushes == 1
    assert tail[4].done
    # drain still leaves nothing behind
    svc.submit(SQL, {"patient_info": _sub(full, 0, 3)})
    assert svc.flush() == 1
    svc.close()


def test_results_device_backed_regardless_of_row_count(base):
    """Every serving path returns tensor-backed tables on the catalog's
    device — the result type must not flip to numpy when the row count
    happens to miss the padded bucket boundary."""
    import torch
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock)
    for n in (5, BUCKET, BUCKET + 3):               # off/on/off boundary
        t = svc.submit(SQL, {"patient_info": _sub(full, 0, n)})
        svc.flush()
        out = t.result(timeout=0)
        assert all(isinstance(v, torch.Tensor)
                   and v.device == store.device
                   for v in out.columns.values()), \
            f"n={n} returned non-device columns"
        assert isinstance(out.valid, torch.Tensor)


def test_catalog_group_shares_one_execution_beyond_cap(base):
    """max_batch_requests never splits identical-catalog-table groups:
    they share ONE execution however many coalesce (splitting would only
    multiply full-plan executions), the cap just triggers their flush."""
    store, full, _ = base
    clock = ManualClock()
    svc = _manual_service(store, clock, max_batch_requests=4)
    tickets = [svc.submit(SQL) for _ in range(10)]
    clock.advance(2.0)
    assert svc.admission_tick() == 10
    assert svc.stats.batch_executions == 1
    assert svc.stats.coalesced_requests == 9
    v0 = np.asarray(tickets[0].result(timeout=0).valid)
    assert (v0 == np.asarray(tickets[-1].result(timeout=0).valid)).all()


@pytest.mark.timeout_guard(120)
def test_loop_service_is_garbage_collectible(base):
    """A dropped (unclosed) service must not leak: the loop thread holds
    only weak callbacks, a finalizer stops it, and the catalog
    invalidation listener detaches — close() stays the orderly path but
    forgetting it costs nothing permanent."""
    import gc
    import time
    import weakref as wr
    store, full, _ = base
    gc.collect()            # flush listeners of earlier tests' dead services
    n_listeners = len(store._invalidation_listeners)
    svc = PredictionService(store, jit=False, admission=AdmissionConfig(
        latency_budget_s=0.01, min_bucket_rows=BUCKET))
    svc.run(SQL, {"patient_info": _sub(full, 0, 5)})
    loop_thread = svc._loop._thread
    ref = wr.ref(svc)
    del svc
    # the loop thread's serve frame may still hold a transient strong ref
    # (the weak callback upgrades for the duration of one call) — only a
    # *lasting* pin is a leak
    deadline = time.time() + 10
    gc.collect()
    while ref() is not None and time.time() < deadline:
        time.sleep(0.05)
        gc.collect()
    assert ref() is None, "admission loop pinned the service against GC"
    loop_thread.join(timeout=10)
    assert not loop_thread.is_alive(), "loop thread leaked after GC"
    gc.collect()
    assert len(store._invalidation_listeners) == n_listeners


def test_bucket_twin_tagged_even_after_self_eviction(base):
    """Regression: under a full cache the twin's zero-cost initial insert
    self-evicts and the post-execution cost re-put re-creates the entry —
    it must carry the model/table tags, or register_model invalidation
    could never reach it (a stale untagged executable pinned forever)."""
    store, full, pipe = base
    clock = ManualClock()
    svc = PredictionService(
        store, jit=False, clock=clock, max_cache_entries=1,
        admission=AdmissionConfig(latency_budget_s=1.0,
                                  min_bucket_rows=BUCKET, background=False))
    t = svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
    svc.flush()
    t.result(timeout=0)
    entries = [svc._exec_cache.entry(k) for k in svc._exec_cache.keys()]
    assert entries and all(("model", "m") in e.tags for e in entries)
    store.register_model("m", pipe)          # re-register fires invalidation
    assert len(svc._exec_cache) == 0
    assert svc.stats.invalidation_evictions >= 1
    svc.close()


# ---------------------------------------------------------------------------
# 4. Background loop: threads, drain-on-close, ticket timeout
# ---------------------------------------------------------------------------

@pytest.mark.timeout_guard(180)
def test_loop_serves_within_budget_and_coalesces(base):
    store, full, _ = base
    svc = PredictionService(store, jit=False, admission=AdmissionConfig(
        latency_budget_s=0.05, min_bucket_rows=BUCKET))
    try:
        barrier = threading.Barrier(4)
        results = {}

        def worker(i):
            barrier.wait(timeout=30)
            t = svc.submit(SQL, {"patient_info": _sub(full, 10 * i, 10)})
            results[i] = t.result(timeout=60)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
            assert not t.is_alive(), "worker deadlocked"
        assert len(results) == 4
        assert all(results[i].capacity == 10 for i in range(4))
        # the barrier puts all 4 in flight inside one budget window: they
        # must not have executed one-by-one
        assert svc.stats.coalesced_requests >= 1
        assert svc.stats.batch_executions < 4
    finally:
        svc.close()


@pytest.mark.timeout_guard(300)
def test_loop_ledger_invariants_under_stress(base):
    """8 threads x 8 requests against a live admission loop: every ticket
    resolves exactly once (double-resolution raises inside _resolve),
    nothing is lost, and requests == executions + coalesced."""
    store, full, _ = base
    svc = PredictionService(store, jit=False, admission=AdmissionConfig(
        latency_budget_s=0.01, min_bucket_rows=BUCKET, max_queue=64))
    n_threads, per_thread = 8, 8
    errors, results = [], {}
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        try:
            barrier.wait(timeout=30)
            for i in range(per_thread):
                lo = (7 * tid + 3 * i) % (N_ROWS - 40)
                n = 1 + (tid + 5 * i) % 30
                t = svc.submit(SQL, {"patient_info": _sub(full, lo, n)})
                out = t.result(timeout=120)
                assert out.capacity == n
                results[(tid, i)] = out
        except Exception as e:                 # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive(), "worker deadlocked"
    svc.close()
    assert not errors
    assert len(results) == n_threads * per_thread
    s = svc.stats
    assert s.submitted == n_threads * per_thread
    assert s.batch_executions + s.coalesced_requests == s.submitted
    assert s.cache_hits + s.cache_misses == s.batch_executions
    # shape discipline held under concurrency too
    assert s.bucket_compiles <= 9             # buckets possible up to 2^8
    info = svc.admission_info()
    assert info["queue_depth"] == 0


@pytest.mark.timeout_guard(120)
def test_close_drains_in_flight_without_deadlock(base):
    store, full, _ = base
    svc = PredictionService(store, jit=False, admission=AdmissionConfig(
        latency_budget_s=30.0, min_bucket_rows=BUCKET))   # loop won't fire
    tickets = [svc.submit(SQL, {"patient_info": _sub(full, 5 * i, 5)})
               for i in range(6)]
    assert not any(t.done for t in tickets)
    svc.close()                                # must drain, not deadlock
    for t in tickets:
        assert t.result(timeout=0).capacity == 5
    assert svc.stats.drain_flushes >= 1
    assert not svc.admission_info()["background_loop"]


@pytest.mark.timeout_guard(120)
def test_ticket_timeout_raises_while_loop_running(base):
    """Regression: with the admission loop alive but the budget far away,
    ``result(timeout=...)`` must raise TimeoutError — not block, not
    return None."""
    store, full, _ = base
    svc = PredictionService(store, jit=False, admission=AdmissionConfig(
        latency_budget_s=30.0, min_bucket_rows=BUCKET))
    try:
        ticket = svc.submit(SQL, {"patient_info": _sub(full, 0, 10)})
        with pytest.raises(TimeoutError):
            ticket.result(timeout=0.05)
        assert not ticket.done
    finally:
        svc.close()
    assert ticket.result(timeout=0).capacity == 10      # drained by close


@pytest.mark.timeout_guard(120)
def test_loop_escape_fails_tickets_instead_of_stranding(base):
    """An error escaping the serve callback (past _serve_group's own
    handlers) must fail the group's tickets via the loop's on_error hook
    — a caller blocked in result() must never hang on a harness bug —
    and surface as admission_info()['loop_error']."""
    store, full, _ = base
    svc = PredictionService(store, jit=False, admission=AdmissionConfig(
        latency_budget_s=0.01, min_bucket_rows=BUCKET))
    try:
        def boom(key, group):
            raise RuntimeError("injected harness bug")
        svc._serve_group = boom            # escapes _serve_ready untouched
        ticket = svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})
        with pytest.raises(RuntimeError, match="injected harness bug"):
            ticket.result(timeout=30)
        assert isinstance(svc.admission_info()["loop_error"], RuntimeError)
    finally:
        del svc._serve_group               # restore class method for close()
        svc.close()


def test_pow2_bucket_respects_non_pow2_max(base):
    """Regression: a non-power-of-two max_rows is a hard cap — doubling
    must not overshoot it for n under the cap (device-memory ceilings)."""
    from repro_torch.core.codegen import pow2_bucket
    assert pow2_bucket(80, min_rows=64, max_rows=100) == 100
    assert pow2_bucket(100, min_rows=64, max_rows=100) == 100
    assert pow2_bucket(101, min_rows=64, max_rows=100) == 200
    # monotone around the cap
    assert pow2_bucket(100, 64, 100) <= pow2_bucket(101, 64, 100)


def test_submit_after_close_raises(base):
    store, full, _ = base
    svc = PredictionService(store, jit=False, admission=AdmissionConfig(
        latency_budget_s=0.01, min_bucket_rows=BUCKET))
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit(SQL, {"patient_info": _sub(full, 0, 5)})


def test_explicit_flush_mode_unchanged_by_refactor(base):
    """The explicit-flush contract survives the Batcher refactor: without an
    admission config, requests wait for flush() regardless of clock."""
    store, full, _ = base
    svc = PredictionService(store, jit=False)
    t = svc.submit(SQL, {"patient_info": _sub(full, 0, 10)})
    with pytest.raises(TimeoutError):
        t.result(timeout=0.02)
    assert svc.flush() == 1
    assert t.result(timeout=0).capacity == 10


# ---------------------------------------------------------------------------
# 5. Differential: one fake-clock admission script through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_base(base):
    from repro.core import ModelStore as JModelStore
    from repro.data import hospital_tables as jhospital
    full = jhospital(N_ROWS, seed=7)["patient_info"]
    store = JModelStore()
    store.register_table("patient_info", full)
    store.register_model("m", _jax_fit(full))
    assert store.model_digest("m") == base[0].model_digest("m")
    return store, full


def _admission_script(svc, clock, full):
    """Deadline flush of a mixed-size stacked group (not due, then due),
    a size flush, a catalog group sharing one execution, and a sweep of
    request sizes over the pow-2 buckets, twice."""
    outs = []
    tickets = [svc.submit(SQL, {"patient_info": _sub(full, lo, n)})
               for lo, n in [(0, 1), (1, BUCKET), (9, BUCKET + 3),
                             (30, 2 * BUCKET + 1)]]
    clock.advance(0.5)
    svc.admission_tick()
    clock.advance(0.6)
    svc.admission_tick()
    tickets += [svc.submit(SQL, {"patient_info": _sub(full, 50 + i, 3 + i)})
                for i in range(5)]
    svc.admission_tick()
    tickets += [svc.submit(SQL) for _ in range(3)]
    clock.advance(2.0)
    svc.admission_tick()
    for n in [1, 2, 5, 8, 9, 17, 31, 33, 64, 65] * 2:
        tickets.append(svc.submit(SQL, {"patient_info": _sub(full, 7, n)}))
        svc.flush()
    outs = [t.result(timeout=0) for t in tickets]
    return outs, svc.admission_info()


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_admission_script_matches_jax(base, jax_base, jit):
    from dataclasses import asdict

    from repro.serve import AdmissionConfig as JAdmissionConfig
    from repro.serve import ManualClock as JManualClock
    from repro.serve import PredictionService as JService
    cfg = dict(latency_budget_s=1.0, min_bucket_rows=BUCKET,
               max_batch_requests=5, background=False)
    jclock, tclock = JManualClock(), ManualClock()
    jsvc = JService(jax_base[0], jit=jit, clock=jclock,
                    admission=JAdmissionConfig(**cfg))
    tsvc = PredictionService(base[0], jit=jit, clock=tclock,
                             admission=AdmissionConfig(**cfg))
    jouts, jinfo = _admission_script(jsvc, jclock, jax_base[1])
    touts, tinfo = _admission_script(tsvc, tclock, base[1])
    if not jit:       # a jitted XLA plan may differ by an FMA ulp
        for jo, to in zip(jouts, touts):
            np.testing.assert_array_equal(to.valid.numpy(),
                                          np.asarray(jo.valid))
            for k in jo.columns:
                np.testing.assert_array_equal(to.columns[k].numpy(),
                                              np.asarray(jo.columns[k]))
    assert asdict(tsvc.stats) == asdict(jsvc.stats)
    assert tinfo == jinfo
    s = tsvc.stats
    assert s.deadline_flushes and s.size_flushes and s.drain_flushes
    assert s.coalesced_requests > 0 and s.bucket_hits > 0
    if jit:
        assert s.jit_traces == s.bucket_compiles + 1
    jsvc.close()
    tsvc.close()
