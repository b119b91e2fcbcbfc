"""Cost-aware eviction policy + invalidation hooks.

Covers the serving layer's shared eviction policy in isolation
(`repro.serve.cache.CostAwareCache`) and wired into `PredictionService`:

- bytes budget respected after *every* insert (including an entry larger
  than the whole budget);
- cost-weighted victim selection beats plain LRU on a synthetic skewed
  workload (an expensive hot entry survives a stream of cheap one-shots);
- `ModelStore.register_model` invalidation evicts exactly the entries
  referencing that model name, with hit/miss counters asserted before and
  after.
"""

import numpy as np
import pytest

from repro_torch.core import ModelStore, OptimizerConfig
from repro_torch.data import hospital_tables
from repro.ml import DecisionTree, Pipeline, PipelineMetadata, StandardScaler
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.serve import PredictionService
from repro_torch.serve.cache import CostAwareCache, value_nbytes


def _carry(pipe):
    """A pipeline fitted by the JAX package, carried into the port as
    numpy state (the two packages' fits are not bitwise equal)."""
    return pipeline_from_state(pipeline_state(pipe))


pytestmark = pytest.mark.tier1


# ---------------------------------------------------------------------------
# CostAwareCache in isolation
# ---------------------------------------------------------------------------

def test_bytes_budget_respected_after_every_insert():
    cache = CostAwareCache(max_entries=100, max_bytes=1000)
    rng = np.random.default_rng(0)
    for i in range(60):
        nbytes = int(rng.integers(1, 400))
        cache.put(f"k{i}", object(), cost_s=float(rng.random()),
                  nbytes=nbytes)
        assert cache.bytes_in_use <= 1000, \
            f"over budget after insert {i}: {cache.bytes_in_use}"
        assert len(cache) <= 100
    assert cache.evictions > 0


def test_same_key_overwrite_does_not_double_count_bytes():
    """Regression: re-inserting an existing key must replace its byte
    charge, not add a second one — under a tight budget a double-counted
    overwrite would blow ``bytes_in_use`` past the budget and spuriously
    evict the entry (or an innocent bystander) on a no-op refresh."""
    cache = CostAwareCache(max_entries=8, max_bytes=250)
    payload = np.zeros(25, np.float32)            # 100 bytes
    cache.put("a", payload, cost_s=1.0)
    cache.put("b", payload, cost_s=1.0)
    assert cache.bytes_in_use == 200
    for _ in range(5):                            # refreshes, same size
        evicted = cache.put("a", payload, cost_s=1.0)
        assert evicted == []
        assert cache.bytes_in_use == 200
    # size-changing overwrite: charge tracks the new payload exactly
    cache.put("a", np.zeros(10, np.float32), cost_s=1.0)    # 40 bytes
    assert cache.bytes_in_use == 140
    cache.put("a", payload, cost_s=1.0, nbytes=100)         # explicit nbytes
    assert cache.bytes_in_use == 200
    assert sorted(cache.keys()) == ["a", "b"]
    # the ledger always equals the sum of resident entries' charges
    assert cache.bytes_in_use == sum(
        cache.entry(k).nbytes for k in cache.keys())


def test_entry_larger_than_budget_never_retained():
    cache = CostAwareCache(max_entries=10, max_bytes=100)
    cache.put("small", 1, cost_s=1.0, nbytes=40)
    cache.put("huge", 2, cost_s=100.0, nbytes=1000)
    assert "huge" not in cache
    assert cache.bytes_in_use <= 100


def test_max_entries_zero_disables_caching():
    cache = CostAwareCache(max_entries=0)
    cache.put("k", 1, cost_s=1.0, nbytes=1)
    assert len(cache) == 0
    assert cache.get("k") is None


def test_nbytes_measured_from_arrays():
    from repro_torch.relational.table import Table
    arr = np.zeros((10, 4), np.float32)
    assert value_nbytes(arr) == 160
    t = Table.from_arrays({"a": np.zeros(8, np.float32),
                           "b": np.zeros(8, np.int32)})
    assert value_nbytes(t) == 8 * 4 + 8 * 4 + 8   # cols + bool valid mask
    assert value_nbytes({"x": arr, "y": [arr]}) == 320


def test_eviction_keeps_costly_hot_entry():
    """Weight = cost x hits: a hot, expensive-to-rebuild entry must survive
    a stream of cheap one-shot entries even when it is the LRU victim."""
    cache = CostAwareCache(max_entries=3)
    cache.put("hot", "H", cost_s=1.0, nbytes=1)
    for _ in range(4):
        assert cache.get("hot") == "H"
    for i in range(20):
        cache.put(f"cheap{i}", i, cost_s=1e-3, nbytes=1)
        assert cache.get("hot") is not None or i < 2, \
            "cost-aware policy evicted the hot expensive entry"
    assert "hot" in cache


class _PlainLRU:
    """Reference LRU with the same budget semantics, for the shootout."""

    def __init__(self, max_entries):
        self.max_entries = max_entries
        self._order = []
        self._values = {}

    def get(self, key):
        if key not in self._values:
            return None
        self._order.remove(key)
        self._order.append(key)
        return self._values[key]

    def put(self, key, value, **_):
        if key in self._values:
            self._order.remove(key)
        self._order.append(key)
        self._values[key] = value
        while len(self._order) > self.max_entries:
            self._values.pop(self._order.pop(0))


def _replay(cache):
    """Skewed workload: one expensive entry re-read every 5th step, cheap
    one-shots streaming through a 3-slot cache in between."""
    recompiles = 0
    for step in range(100):
        if step % 5 == 0:
            if cache.get("expensive") is None:
                recompiles += 1              # simulate the costly rebuild
                cache.put("expensive", "E", cost_s=1.0, nbytes=1)
        cache.put(f"one_shot_{step}", step, cost_s=1e-3, nbytes=1)
    return recompiles


def test_cost_weighted_selection_beats_plain_lru():
    lru_recompiles = _replay(_PlainLRU(max_entries=3))
    cost_recompiles = _replay(CostAwareCache(max_entries=3))
    assert cost_recompiles == 1              # initial compile only
    assert lru_recompiles == 20              # evicted before every re-read
    assert cost_recompiles < lru_recompiles


def test_evict_by_tag_exact():
    cache = CostAwareCache(max_entries=10)
    cache.put("a1", 1, cost_s=1.0, nbytes=1, tags=(("model", "A"),))
    cache.put("a2", 2, cost_s=1.0, nbytes=1,
              tags=(("model", "A"), ("table", "t")))
    cache.put("b", 3, cost_s=1.0, nbytes=1, tags=(("model", "B"),))
    cache.put("plain", 4, cost_s=1.0, nbytes=1)
    evicted = cache.evict_by_tag(("model", "A"))
    assert sorted(evicted) == ["a1", "a2"]
    assert "b" in cache and "plain" in cache


# ---------------------------------------------------------------------------
# Invalidation wired through ModelStore -> PredictionService
# ---------------------------------------------------------------------------

FEATS = ["age", "gender", "pregnant", "rcount"]
SQL_A = "SELECT pid, PREDICT(MODEL='model_a') AS p FROM patient_info"
SQL_B = "SELECT pid, PREDICT(MODEL='model_b') AS p FROM patient_info"


def _jax_pipeline(data, name, depth):
    sc = StandardScaler(FEATS).fit(data)
    pipe = Pipeline([sc], DecisionTree(task="regression", max_depth=depth),
                    PipelineMetadata(name=name, task="regression"))
    pipe.fit({k: data[k] for k in FEATS}, data["length_of_stay"])
    return pipe


def _pipeline(data, name, depth):
    return _carry(_jax_pipeline(data, name, depth))


def _service(store, **kwargs):
    # Small trees would inline to relational CASE ops, leaving no inference
    # subtree to capture; keep predict_model nodes intact so these tests
    # exercise the result-cache tier deterministically.
    return PredictionService(
        store, optimizer_config=OptimizerConfig(enable_model_inlining=False),
        **kwargs)


@pytest.fixture()
def two_model_store():
    store = ModelStore(device="cpu")
    for n, t in hospital_tables(300, seed=11).items():
        store.register_table(n, t)
    pi = store.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    store.register_model("model_a", _pipeline(data, "model_a", 4))
    store.register_model("model_b", _pipeline(data, "model_b", 5))
    return store


def test_register_model_evicts_exactly_referencing_entries(two_model_store):
    store = two_model_store
    svc = _service(store)
    svc.run(SQL_A)
    svc.run(SQL_B)
    assert svc.cache_info()["entries"] == 2
    assert svc.cache_info()["result_entries"] == 2
    assert (svc.stats.cache_hits, svc.stats.cache_misses) == (0, 2)

    # byte-identical re-registration: the content digest would still HIT —
    # only the invalidation hook can force the miss
    store.register_model("model_a", store.get_model("model_a"))

    info = svc.cache_info()
    assert info["entries"] == 1, "model_b entry must survive"
    assert info["result_entries"] == 1
    assert svc.stats.invalidation_evictions == 2   # one exec + one result

    svc.run(SQL_B)                     # untouched model still hits
    assert (svc.stats.cache_hits, svc.stats.cache_misses) == (1, 2)
    svc.run(SQL_A)                     # re-registered model must miss
    assert (svc.stats.cache_hits, svc.stats.cache_misses) == (1, 3)
    assert svc.cache_info()["entries"] == 2


def test_register_table_evicts_referencing_entries(two_model_store):
    store = two_model_store
    svc = _service(store)
    svc.run(SQL_A)
    assert svc.cache_info()["entries"] == 1
    store.register_table("patient_info", store.get_table("patient_info"))
    assert svc.cache_info()["entries"] == 0
    assert svc.cache_info()["result_entries"] == 0


def test_unrelated_registration_evicts_nothing(two_model_store):
    store = two_model_store
    svc = _service(store)
    svc.run(SQL_A)
    before = svc.cache_info()
    store.register_model("model_c",
                         _pipeline({c: np.asarray(
                             store.get_table("patient_info").column(c))
                             for c in store.get_table("patient_info").names},
                             "model_c", 3))
    store.register_table("blood_tests", store.get_table("blood_tests"))
    after = svc.cache_info()
    assert after["entries"] == before["entries"]
    assert after["result_entries"] == before["result_entries"]
    assert svc.stats.invalidation_evictions == 0


# ---------------------------------------------------------------------------
# Differential: budgets, eviction and invalidation through both packages
# ---------------------------------------------------------------------------

def _two_model_pair():
    from repro.core import ModelStore as JModelStore
    from repro.data import hospital_tables as jhospital
    js, ts = JModelStore(), ModelStore(device="cpu")
    for (n, jt), tt in zip(jhospital(300, seed=11).items(),
                           hospital_tables(300, seed=11).values()):
        js.register_table(n, jt)
        ts.register_table(n, tt)
    pi = js.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    for name, depth in (("model_a", 4), ("model_b", 5), ("model_c", 3)):
        pipe = _jax_pipeline(data, name, depth)
        js.register_model(name, pipe)
        ts.register_model(name, _carry(pipe))
    return js, ts


def _eviction_script(svc, store):
    sql_c = "SELECT pid, PREDICT(MODEL='model_c') AS p FROM patient_info"
    outs = [svc.run(q) for q in (SQL_A, SQL_B, sql_c, SQL_A, SQL_B)]
    outs.append(svc.run("SELECT pid, age, PREDICT(MODEL='model_a') AS p "
                        "FROM patient_info"))
    store.register_model("model_a", store.get_model("model_a"))
    outs += [svc.run(q) for q in (SQL_B, SQL_A, sql_c)]
    store.register_table("patient_info", store.get_table("patient_info"))
    outs += [svc.run(q) for q in (SQL_A, SQL_B)]
    return outs, svc.cache_info()


@pytest.mark.parametrize("budgets", [
    dict(), dict(max_cache_entries=0), dict(enable_result_cache=False)],
    ids=["unbounded", "no_exec_cache", "no_result_cache"])
def test_eviction_script_matches_jax(budgets):
    """The invalidation hooks free the same entries in both packages, and
    the degenerate budgets behave the same.  (Under slot or byte pressure
    the victim ranks by *measured* compile or execution time, which the
    two packages need not share, so pressure is pinned by the single-
    package cases above.)"""
    from dataclasses import asdict

    from repro.core import OptimizerConfig as JOptimizerConfig
    from repro.serve import PredictionService as JService
    js, ts = _two_model_pair()
    jsvc = JService(js, jit=False, optimizer_config=JOptimizerConfig(
        enable_model_inlining=False), **budgets)
    tsvc = _service(ts, jit=False, **budgets)
    (jouts, jinfo), (touts, tinfo) = _eviction_script(jsvc, js), \
        _eviction_script(tsvc, ts)
    for jo, to in zip(jouts, touts):
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
        for k in jo.columns:
            np.testing.assert_array_equal(to.columns[k].numpy(),
                                          np.asarray(jo.columns[k]))
    assert asdict(tsvc.stats) == asdict(jsvc.stats)
    if budgets.get("max_cache_entries", 1):
        assert tsvc.stats.cache_hits > 0
        assert tsvc.stats.invalidation_evictions > 0
    else:
        assert tsvc.stats.cache_hits == 0
    # the executable tier's bytes weigh plan constants, which the port
    # holds differently (its trees also keep their device tensors)
    tinfo.pop("bytes"), jinfo.pop("bytes")
    assert tinfo == jinfo


def test_result_bytes_count_tensor_memory():
    """``value_nbytes`` of a port table is the bytes its tensors hold,
    equal to the JAX package's count for the same columns."""
    import torch

    from repro.relational.table import Table as JTable
    from repro.serve.cache import value_nbytes as jnbytes
    from repro_torch.relational.table import Table
    cols = {"a": np.zeros(10, np.float32), "b": np.arange(10, dtype=np.int64)}
    t = Table.from_arrays(cols)
    assert value_nbytes(t) == 10 * 4 + 10 * 8 + 10
    assert value_nbytes(torch.zeros(3, 5)) == 60
    assert value_nbytes(t) == jnbytes(JTable.from_arrays(
        {"a": cols["a"], "b": cols["b"].astype(np.int32)})) + 10 * 4
