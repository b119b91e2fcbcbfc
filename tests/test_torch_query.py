"""The slice as a whole: SQL ``PREDICT`` queries through both packages'
``parse_query -> CrossOptimizer -> execute``, on the same hospital tables
(4,000 patients) and the same fitted pipelines — the Fig 2d forest
(``benchmarks/fig2d_tree_gemm.py``: 16 trees, depth 7, over patient_info's
four features) and a boosted regressor — fitted by the JAX package and
carried across as numpy state.

Every tree strategy is forced in turn (traversal, dense GEMM, and the
kernel: ``"pallas"`` in the JAX package, ``"cuda"`` in the port, whose
plain version runs on CPU tensors).  Prediction columns, masks and ints
are held **bitwise**.  Query (c) averages ``PREDICT_PROBA`` per group: the
probability is a softmax, which XLA and torch compute with a 1-ulp
difference, so that column is held at ``rtol=1e-6``.

The SQL grammar (the same in both packages) takes only a column inside an
aggregate, so query (c) names the ``PREDICT_PROBA`` column by the
placeholder the parser gives it (``__pred_0_rf``), registered through the
WHERE clause.
"""

import numpy as np
import pytest

from repro import core as jcore
from repro import ml as jml
from repro.data import hospital_tables as jhospital
from repro_torch import core as tcore
from repro_torch.data import hospital_tables as thospital
from repro_torch.kernels.tree_gemm import ops as tg_ops
from repro_torch.ml.convert import pipeline_from_state, pipeline_state

_FEAT = ["age", "gender", "pregnant", "rcount"]

QUERIES = {
    "a_scan": "SELECT pid, PREDICT(MODEL='rf') AS s FROM patient_info",
    "b_three_way_join": "SELECT pid, age, PREDICT(MODEL='rf') AS s "
                        "FROM patient_info JOIN blood_tests ON pid "
                        "JOIN prenatal_tests ON pid "
                        "WHERE pregnant = 1 AND PREDICT(MODEL='rf') > 0",
    "c_group_avg_proba": "SELECT gender, AVG(__pred_0_rf) AS p "
                         "FROM patient_info "
                         "WHERE PREDICT_PROBA(MODEL='rf') >= 0 "
                         "GROUP BY gender",
    "d_boosted": "SELECT pid, rcount, PREDICT(MODEL='gbt') AS los "
                 "FROM patient_info WHERE age > 30",
}
_PROBA_COLUMNS = {"p"}


@pytest.fixture(scope="module")
def stores():
    jstore, tstore = jcore.ModelStore(), tcore.ModelStore(device="cpu")
    for (name, jt), tt in zip(jhospital(4000, seed=7).items(),
                              thospital(4000, seed=7).values()):
        jstore.register_table(name, jt)
        tstore.register_table(name, tt)
    pi = jstore.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    sc = jml.StandardScaler(_FEAT).fit(data)
    rf = jml.Pipeline([sc], jml.RandomForest(n_trees=16, max_depth=7),
                      jml.PipelineMetadata(name="rf", task="classification"))
    rf.fit({k: data[k] for k in _FEAT},
           (data["length_of_stay"] > 7).astype(np.int32))
    gbt = jml.Pipeline([sc], jml.GradientBoostedTrees(n_trees=12,
                                                      max_depth=4),
                       jml.PipelineMetadata(name="gbt", task="regression"))
    gbt.fit({k: data[k] for k in _FEAT}, data["length_of_stay"])
    for name, pipe in (("rf", rf), ("gbt", gbt)):
        jstore.register_model(name, pipe)
        tstore.register_model(name, pipeline_from_state(pipeline_state(pipe)))
    return jstore, tstore


def _run(stores, query, strategy, force_kernel=False):
    jstore, tstore = stores
    sql = QUERIES[query]
    jplan, _ = jcore.CrossOptimizer(jstore, jcore.OptimizerConfig(
        tree_strategy=strategy)).optimize(jcore.parse_query(sql, jstore))
    tplan, trep = tcore.CrossOptimizer(tstore, tcore.OptimizerConfig(
        tree_strategy="cuda" if strategy == "pallas" else strategy)
    ).optimize(tcore.parse_query(sql, tstore))
    want = jcore.execute(jplan, jstore, jcore.ExecutionConfig(
        use_pallas_tree_gemm=force_kernel))
    got = tcore.execute(tplan, tstore, tcore.ExecutionConfig(
        use_cuda_tree_gemm=force_kernel))
    return want, got, tplan


def _assert_same(want, got):
    assert sorted(got.columns) == sorted(want.columns)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(np.asarray(want.valid).sum()) > 0
    for name in want.columns:
        w, g = np.asarray(want.columns[name]), got.columns[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in _PROBA_COLUMNS:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("strategy", ["traversal", "gemm", "pallas"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_matches_jax(stores, query, strategy):
    want, got, tplan = _run(stores, query, strategy)
    _assert_same(want, got)
    ops = {n.op for n in tplan.nodes.values()}
    assert ("tree_gemm" in ops) == (strategy != "traversal")


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_forced_kernel_matches_jax(stores, query):
    """``ExecutionConfig(use_cuda_tree_gemm=True)`` against the JAX
    package's ``use_pallas_tree_gemm=True`` on a dense-GEMM plan."""
    want, got, _ = _run(stores, query, "gemm", force_kernel=True)
    _assert_same(want, got)


@pytest.mark.parametrize("query", ["a_scan", "b_three_way_join", "d_boosted"])
def test_strategies_agree_bitwise_in_port(stores, query):
    """Every forced strategy, and whatever the measured crossover picks."""
    outs = [_run(stores, query, s)[1] for s in ("traversal", "gemm",
                                                "pallas", "auto")]
    for out in outs[1:]:
        np.testing.assert_array_equal(out.valid.numpy(),
                                      outs[0].valid.numpy())
        for name in outs[0].columns:
            if query == "d_boosted" and name == "los":
                # boosting folds base + lr * tree per tree in traversal but
                # sums the scaled trees first in the GEMM forms
                np.testing.assert_allclose(out.columns[name].numpy(),
                                           outs[0].columns[name].numpy(),
                                           rtol=1e-5)
                continue
            np.testing.assert_array_equal(out.columns[name].numpy(),
                                          outs[0].columns[name].numpy())


def test_cpu_run_launches_no_kernel(stores):
    before = tg_ops.launches
    _run(stores, "a_scan", "pallas")
    assert tg_ops.launches == before


def test_node_hook_profiles_every_node(stores):
    """The EXPLAIN ANALYZE seam: the hook sees every node once, in order,
    with its value and a wall time, and the answer is unchanged."""
    _, tstore = stores
    plan, _ = tcore.CrossOptimizer(tstore, tcore.OptimizerConfig(
        tree_strategy="cuda")).optimize(
            tcore.parse_query(QUERIES["b_three_way_join"], tstore))
    seen = []
    fn = tcore.compile_plan(plan, tstore, node_hook=lambda nid, node, value,
                            dt: seen.append((nid, node.op, dt)))
    tabs = {n: tstore.get_table(n) for n in tstore.table_names()}
    out = fn(tabs)
    assert [nid for nid, _, _ in seen] == plan.topo_order()
    assert all(dt >= 0 for _, _, dt in seen)
    assert "tree_gemm" in {op for _, op, _ in seen}
    plain = tcore.compile_plan(plan, tstore)(tabs)
    np.testing.assert_array_equal(out.columns["s"].numpy(),
                                  plain.columns["s"].numpy())
