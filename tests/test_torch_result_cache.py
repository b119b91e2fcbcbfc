"""Cross-query materialized sub-plan result cache, on the port.

The cases of ``tests/test_result_cache.py`` run on the port's service
(pipelines fitted by the JAX package, carried across), and differential
scripts drive both packages' services through the same capture, splice,
splice-upgrade and rematerialization sequence: answers bitwise equal to
the JAX service with ``jit=False``, ``ServiceStats`` equal field by field.

Two different queries sharing a deterministic ``featurize -> predict``
prefix over the same catalog table: the first query's execution captures
the subtree's materialized value; the second query splices it in as a
``materialized`` leaf and executes only its residual plan.  Guarantees
under test: splicing is bit-exact vs uncached execution, never fires for
caller-supplied tables, survives result eviction via re-materialization,
keys on table registration versions, and the subtree-signature machinery
is self-consistent (incl. the structural-CSE upgrade to subplan_dedup).
"""

import copy

import numpy as np
import pytest

from repro_torch.core import CrossOptimizer, ModelStore, parse_query
from repro_torch.core.ir import (Category, Node, Plan, plan_signature,
                           subtree_signatures)
from repro_torch.data import hospital_tables
from repro.ml import DecisionTree, Pipeline, PipelineMetadata, StandardScaler
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.relational.table import Table
from repro_torch.serve import PredictionService


def _carry(pipe):
    """A pipeline fitted by the JAX package, carried into the port as
    numpy state (the two packages' fits are not bitwise equal)."""
    return pipeline_from_state(pipeline_state(pipe))


pytestmark = pytest.mark.tier1

FEATS = ["age", "gender", "pregnant", "rcount"]
SQL_A = "SELECT pid, PREDICT(MODEL='m') AS score FROM patient_info"
SQL_B = "SELECT pid, age, PREDICT(MODEL='m') AS score FROM patient_info"


def _jax_pipeline(data, depth=6):
    sc = StandardScaler(FEATS).fit(data)
    pipe = Pipeline([sc], DecisionTree(task="regression", max_depth=depth),
                    PipelineMetadata(name="m", task="regression"))
    pipe.fit({k: data[k] for k in FEATS}, data["length_of_stay"])
    return pipe


def _pipeline(data, depth=6):
    return _carry(_jax_pipeline(data, depth))


def _make_store(n_rows=400, seed=7):
    store = ModelStore(device="cpu")
    for n, t in hospital_tables(n_rows, seed=seed).items():
        store.register_table(n, t)
    pi = store.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    store.register_model("m", _pipeline(data))
    return store


@pytest.fixture()
def store():
    return _make_store()


# ---------------------------------------------------------------------------
# Splicing
# ---------------------------------------------------------------------------

def test_second_query_splices_and_is_bit_exact(store, assert_tables_equal):
    svc = PredictionService(store)
    svc.run(SQL_A)
    assert svc.stats.result_puts == 1
    out_b = svc.run(SQL_B)
    assert svc.stats.result_hits == 1
    assert svc.stats.spliced_executions == 1

    uncached = PredictionService(store, enable_result_cache=False)
    assert_tables_equal(out_b, uncached.run(SQL_B))


def test_alias_only_difference_still_reuses(store, assert_tables_equal):
    """Output aliases live in rename/project attrs; the capture root sits
    below them, so `... AS score` and `... AS s` share the cached
    inference subtree."""
    svc = PredictionService(store)
    svc.run("SELECT pid, PREDICT(MODEL='m') AS score FROM patient_info")
    out = svc.run("SELECT pid, PREDICT(MODEL='m') AS s FROM patient_info")
    assert svc.stats.result_hits == 1, \
        "alias-only rename difference defeated sub-plan reuse"
    uncached = PredictionService(store, enable_result_cache=False)
    want = uncached.run(
        "SELECT pid, PREDICT(MODEL='m') AS s FROM patient_info")
    assert_tables_equal(out, want)


def test_residual_plan_contains_no_inference_ops(store):
    svc = PredictionService(store)
    svc.run(SQL_A)
    compiled_b = svc.compile(SQL_B)
    assert compiled_b.splice is not None
    residual_ops = {n.op for n in compiled_b.plan.nodes.values()}
    assert "materialized" in residual_ops
    assert not residual_ops & {"featurize", "predict_model", "tree_gemm",
                               "matmul_bias"}, \
        f"inference ops survived splicing: {residual_ops}"


def test_rematerialization_after_result_eviction(store, assert_tables_equal):
    """A spliced executable whose cached value was evicted rebuilds it from
    the retained subtree plan — correctness does not depend on residency."""
    svc = PredictionService(store)
    svc.run(SQL_A)
    out1 = svc.run(SQL_B)                  # spliced, cache resident
    svc._result_cache.evict_if(lambda e: True)
    assert svc.cache_info()["result_entries"] == 0
    out2 = svc.run(SQL_B)                  # spliced, must re-materialize
    assert svc.stats.rematerializations == 1
    assert svc.stats.result_misses == 1
    assert svc.cache_info()["result_entries"] == 1   # repopulated
    assert_tables_equal(out1, out2)


def test_parameterized_query_populates_and_reuses_cache(store):
    """A parameter in the WHERE clause used to poison every enclosing
    subtree (`plan_params` vetoed the candidate), so hot parameterized
    queries never captured.  The frontend now routes param-bearing
    conjuncts above ``attach_column``, leaving the inference prefix
    cacheable; distinct bindings then splice from one entry."""
    svc = PredictionService(store)
    q = ("SELECT pid, PREDICT(MODEL='m') AS s FROM patient_info "
         "WHERE age > :lo")
    out1 = svc.run(q, params={"lo": 40.0})
    assert svc.stats.result_puts == 1
    out2 = svc.run(q, params={"lo": 55.0})   # same signature: warm executable
    # a *different* query sharing the inference prefix splices the value
    # the parameterized query captured
    out3 = svc.run("SELECT pid, age, PREDICT(MODEL='m') AS s "
                   "FROM patient_info WHERE age > :lo", params={"lo": 30.0})
    assert svc.stats.result_hits == 1
    assert svc.stats.spliced_executions == 1
    # bindings behave like the literal queries they stand for
    lit = PredictionService(store, enable_result_cache=False)
    for out, lo in ((out1, 40.0), (out2, 55.0)):
        want = lit.run("SELECT pid, PREDICT(MODEL='m') AS s "
                       f"FROM patient_info WHERE age > {lo}")
        assert out.to_pydict() == want.to_pydict()


def test_structural_limit_param_binds_per_value(store):
    """``LIMIT :n`` binds at plan-build time: each value is its own plan
    signature (documented tradeoff), results are exact, and repeats of a
    value reuse its executable."""
    svc = PredictionService(store)
    q = "SELECT pid FROM patient_info LIMIT :n"
    r10 = svc.run(q, params={"n": 10})
    r20 = svc.run(q, params={"n": 20})
    r10b = svc.run(q, params={"n": 10})
    assert len(r10.to_pydict()["pid"]) == 10
    assert len(r20.to_pydict()["pid"]) == 20
    assert r10b.to_pydict() == r10.to_pydict()
    assert svc.stats.cache_misses == 2      # one signature per LIMIT value
    assert svc.stats.cache_hits == 1


def test_overridden_tables_never_capture_or_splice(store):
    pi = store.get_table("patient_info")
    sub = Table({k: v[:100] for k, v in pi.columns.items()},
                pi.valid[:100], pi.schema)
    svc = PredictionService(store)
    svc.run(SQL_A, {"patient_info": sub})
    assert svc.cache_info()["result_entries"] == 0
    assert svc.stats.result_puts == 0
    compiled = svc.compile(SQL_A, {"patient_info": sub})
    assert compiled.capture is None and compiled.splice is None


def test_chunked_execution_populates_capture(store, assert_tables_equal):
    """Morsel execution assembles the captured subtree value from chunk
    pieces; a later query splices it bit-exactly."""
    chunked = PredictionService(store, chunk_rows=128)    # 400 rows -> 4
    chunked.run(SQL_A)
    assert chunked.stats.chunks_executed > 0
    assert chunked.stats.result_puts == 1
    out_b = chunked.run(SQL_B)
    assert chunked.stats.result_hits == 1
    uncached = PredictionService(store, enable_result_cache=False)
    assert_tables_equal(out_b, uncached.run(SQL_B))


def test_result_key_tracks_table_version(store, assert_tables_equal):
    svc = PredictionService(store)
    svc.run(SQL_A)
    out_b1 = svc.run(SQL_B)
    # re-register with shifted data: version bump + invalidation hook
    pi = store.get_table("patient_info")
    shifted = pi.with_columns(
        {"age": np.asarray(pi.column("age"), np.float32) + 1.0})
    store.register_table("patient_info", shifted)
    out_b2 = svc.run(SQL_B)
    fresh = PredictionService(store, enable_result_cache=False)
    assert_tables_equal(out_b2, fresh.run(SQL_B))
    assert not (np.asarray(out_b1.columns["age"])
                == np.asarray(out_b2.columns["age"])).all()


def test_capture_entry_upgrades_to_splice_when_other_query_produces(store, assert_tables_equal):
    """Consumer-compiled-first ordering: B compiles while the cache is
    empty (capture mode), another query later materializes the shared
    subtree -> B's next warm hit recompiles to its residual once and
    splices from then on.  The producer itself never 'upgrades' onto its
    own capture (zero-compile warm repeats stay zero-compile)."""
    svc = PredictionService(store)
    out_b1 = svc.run(SQL_B)                  # B produces (capture mode)
    assert svc.compile(SQL_B).capture is not None
    assert svc.stats.splice_upgrades == 0    # own value: no upgrade

    svc._result_cache.evict_if(lambda e: True)
    svc.run(SQL_A)                           # A captures + repopulates
    assert svc.stats.result_puts == 2

    out_b2 = svc.run(SQL_B)                  # warm hit -> upgrade -> splice
    assert svc.stats.splice_upgrades == 1
    assert svc.stats.result_hits >= 1
    compiled_b = svc.compile(SQL_B)
    assert compiled_b.splice is not None and compiled_b.capture is None
    assert svc.stats.splice_upgrades == 1    # upgrade happens exactly once
    assert_tables_equal(out_b1, out_b2)


def test_close_and_gc_detach_invalidation_listener(store):
    import gc
    n0 = len(store._invalidation_listeners)
    svc = PredictionService(store)
    assert len(store._invalidation_listeners) == n0 + 1
    svc.close()
    assert len(store._invalidation_listeners) == n0
    svc.close()                              # idempotent

    svc2 = PredictionService(store)
    assert len(store._invalidation_listeners) == n0 + 1
    del svc2
    gc.collect()
    assert len(store._invalidation_listeners) == n0, \
        "garbage-collected service left a dead listener behind"


def test_disabled_result_cache_is_inert(store):
    svc = PredictionService(store, enable_result_cache=False)
    svc.run(SQL_A)
    svc.run(SQL_B)
    assert "result_entries" not in svc.cache_info()
    assert svc.stats.result_puts == 0
    assert svc.stats.spliced_executions == 0
    compiled = svc.compile(SQL_A)
    assert compiled.capture is None and compiled.splice is None


# ---------------------------------------------------------------------------
# Subtree-signature machinery
# ---------------------------------------------------------------------------

def test_subtree_signature_consistent_with_plan_signature(store):
    plan = parse_query(SQL_A, store)
    sigs = subtree_signatures(plan)
    assert sigs[plan.output] == plan_signature(plan)
    # every reachable node is signed
    assert set(sigs) == set(plan.nodes)


def test_shared_prefix_has_equal_subtree_signature(store):
    """The reuse precondition: after optimization, queries A and B carry a
    subtree with the same signature."""
    opt = CrossOptimizer(store)
    pa, _ = opt.optimize(parse_query(SQL_A, store))
    pb, _ = opt.optimize(parse_query(SQL_B, store))
    shared = set(subtree_signatures(pa).values()) \
        & set(subtree_signatures(pb).values())
    assert shared, "no shared subtree between A and B after optimization"


def test_structural_cse_merges_content_identical_models(store):
    """subplan_dedup's structural pass merges two predict chains whose model
    objects are distinct Python objects with identical content — the old
    id()-keyed pass could not."""
    pipe = store.get_model("m")
    clone = copy.deepcopy(pipe)
    plan = Plan()
    scan = plan.emit("scan", Category.RA, [], "table", table="patient_info")
    f1 = plan.emit("featurize", Category.MLD, [scan], "matrix",
                   featurizers=pipe.featurizers, pipeline_name="m",
                   input_columns=tuple(FEATS))
    p1 = plan.emit("predict_model", Category.MLD, [f1], "vector",
                   model=pipe.model, model_name="m", task="regression",
                   proba=False)
    f2 = plan.emit("featurize", Category.MLD, [scan], "matrix",
                   featurizers=clone.featurizers, pipeline_name="m",
                   input_columns=tuple(FEATS))
    p2 = plan.emit("predict_model", Category.MLD, [f2], "vector",
                   model=clone.model, model_name="m", task="regression",
                   proba=False)
    a1 = plan.emit("attach_column", Category.RA, [scan, p1], "table",
                   name="s1")
    a2 = plan.emit("attach_column", Category.RA, [a1, p2], "table",
                   name="s2")
    plan.output = a2

    from repro_torch.core.optimizer import OptimizationReport
    from repro_torch.core.rules import subplan_dedup
    report = OptimizationReport()
    changed = subplan_dedup.apply(plan, store, None, report)
    assert changed
    preds = [n for n in plan.nodes.values() if n.op == "predict_model"]
    feats = [n for n in plan.nodes.values() if n.op == "featurize"]
    assert len(preds) == 1 and len(feats) == 1, plan.pretty()


def test_udf_subtrees_are_never_merged_or_cached(store):
    plan = Plan()
    scan = plan.emit("scan", Category.RA, [], "table", table="patient_info")
    u1 = plan.emit("udf", Category.UDF, [scan], "vector",
                   fn=lambda cols: cols["age"] * 2)
    u2 = plan.emit("udf", Category.UDF, [scan], "vector",
                   fn=lambda cols: cols["age"] * 2)
    a1 = plan.emit("attach_column", Category.RA, [scan, u1], "table",
                   name="x")
    a2 = plan.emit("attach_column", Category.RA, [a1, u2], "table",
                   name="y")
    plan.output = a2
    from repro_torch.core.optimizer import OptimizationReport
    from repro_torch.core.rules import subplan_dedup
    before = len(plan.nodes)
    subplan_dedup.apply(plan, store, None, OptimizationReport())
    udfs = [n for n in plan.nodes.values() if n.op == "udf"]
    assert len(udfs) == 2, "UDF subtrees must never merge"
    assert len(plan.nodes) == before


# ---------------------------------------------------------------------------
# Differential: the same call script through both packages' services
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX store, port store) over the same tables and the same fitted
    pipeline (the JAX fit is deterministic: equal digests)."""
    from repro.core import ModelStore as JModelStore
    from repro.data import hospital_tables as jhospital
    js = JModelStore()
    for n, t in jhospital(400, seed=7).items():
        js.register_table(n, t)
    pi = js.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    js.register_model("m", _jax_pipeline(data))
    ts = _make_store()
    assert js.model_digest("m") == ts.model_digest("m")
    return js, ts


def _same(jout, tout):
    assert sorted(tout.columns) == sorted(jout.columns)
    np.testing.assert_array_equal(tout.valid.numpy(), np.asarray(jout.valid))
    for name in jout.columns:
        want, got = np.asarray(jout.columns[name]), \
            tout.columns[name].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _result_script(svc):
    """Capture (B), eviction, capture by another query (A), B's warm hit
    upgrading to a splice, a third query splicing, a rematerialization
    after the result tier is emptied, and a parameterized query."""
    outs = [svc.run(SQL_B), svc.run(SQL_B)]
    svc._result_cache.evict_if(lambda e: True)
    outs += [svc.run(SQL_A), svc.run(SQL_B), svc.run(SQL_B)]
    outs.append(svc.run("SELECT pid, PREDICT(MODEL='m') AS s "
                        "FROM patient_info WHERE age > 40"))
    svc._result_cache.evict_if(lambda e: True)
    outs.append(svc.run(SQL_B))                  # rematerializes
    outs += [svc.sql("SELECT pid, PREDICT(MODEL='m') AS s FROM "
                     "patient_info WHERE age > ?", params=[v])
             for v in (20, 60, 20)]
    return outs


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_result_script_matches_jax(pair, jit):
    from dataclasses import asdict

    from repro.serve import PredictionService as JService
    js, ts = pair
    jsvc, tsvc = JService(js, jit=jit), PredictionService(ts, jit=jit)
    jouts, touts = _result_script(jsvc), _result_script(tsvc)
    if not jit:       # a jitted XLA plan may differ by an FMA ulp
        for jo, to in zip(jouts, touts):
            _same(jo, to)
    ts_stats, js_stats = asdict(tsvc.stats), asdict(jsvc.stats)
    assert ts_stats == js_stats
    assert ts_stats["splice_upgrades"] == 1
    assert ts_stats["rematerializations"] >= 1
    tinfo, jinfo = tsvc.cache_info(), jsvc.cache_info()
    # the executable tier's bytes weigh plan constants, which the port
    # holds differently (its trees also keep their device tensors)
    tinfo.pop("bytes"), jinfo.pop("bytes")
    assert tinfo == jinfo     # result_bytes included: same dtypes, rows
    jsvc.close()
    tsvc.close()
