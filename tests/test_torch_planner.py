"""The port's planning layer against the JAX package's: the same SQL goes
through both packages' ``parse_query`` + ``CrossOptimizer`` over catalogs
holding the same tables and the same fitted pipelines (fitted by the JAX
package, carried across as numpy state).

The same rules must fire, with the same report lines (the kernel strategy
reads ``"cuda"`` in the port where the JAX package says ``"pallas"``), and
the optimized plans must have the same node ops and topology.  The tree
strategy is forced in every config: under ``"auto"`` it comes from timing
each package's own strategies, so it may differ by design; for the same
reason report lines that quote measured costs (``tree_strategy``, and
``runtime_selection``'s measured-crossover note) are left out.  The plans
are also executed: masks and ints bitwise, floats within ``rtol=1e-6``
(the one-hot LR model's products are summed by XLA and by torch in their
own orders).
"""

import re

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import ml as jml
from repro.data import flight_features as jflights
from repro.data import hospital_tables as jhospital
from repro.relational import Table as JTable
from repro_torch import core as tcore
from repro_torch.data import hospital_tables as thospital
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.relational import Table as TTable

_FEAT = ["age", "gender", "pregnant", "rcount", "hematocrit",
         "neutrophils", "bp"]


@pytest.fixture(scope="module")
def stores():
    """(jax store, port store) over hospital + flights tables, with the los
    tree, its external twin and the flights LR pipeline registered."""
    jstore, tstore = jcore.ModelStore(), tcore.ModelStore(device="cpu")
    for (name, jt), tt in zip(jhospital(4000, seed=7).items(),
                              thospital(4000, seed=7).values()):
        jstore.register_table(name, jt)
        tstore.register_table(name, tt)
    data = {c: np.asarray(jstore.get_table(t).column(c))
            for t in jstore.table_names() for c in jstore.get_table(t).names}
    los = jml.Pipeline([jml.StandardScaler(_FEAT).fit(data)],
                       jml.DecisionTree(task="regression", max_depth=7,
                                        min_leaf=15),
                       jml.PipelineMetadata(name="los", task="regression"))
    los.fit({k: data[k] for k in _FEAT}, data["length_of_stay"])
    ext = pipeline_state(los)
    ext["metadata"]["flavor"] = "external"
    fcols, fy = jflights(4000, seed=3)
    jstore.register_table("flights", JTable.from_pydict({**fcols,
                                                         "delayed": fy}))
    tstore.register_table("flights", TTable.from_pydict({**fcols,
                                                         "delayed": fy}))
    ohe = jml.OneHotEncoder(["origin", "dest", "carrier"]).fit(fcols)
    sc = jml.StandardScaler(["distance", "taxi_out", "dep_hour"]).fit(fcols)
    delay = jml.Pipeline([ohe, sc], jml.LogisticRegression(l1=0.01,
                                                           steps=150),
                         jml.PipelineMetadata(name="delay"))
    delay.fit(fcols, fy)
    for name, pipe in (("los", los), ("delay", delay)):
        jstore.register_model(name, pipe)
        tstore.register_model(name, pipeline_from_state(pipeline_state(pipe)))
    import copy
    jext = copy.copy(los)
    jext.metadata = copy.copy(los.metadata)
    jext.metadata.flavor = "external"
    jstore.register_model("los_ext", jext)
    tstore.register_model("los_ext", pipeline_from_state(ext))
    return jstore, tstore


QUERIES = {   # tests/test_frontends.py and tests/test_optimizer_rules.py
    "projection": "SELECT pid, age FROM patient_info WHERE age > 50",
    "aggregates": "SELECT COUNT(*) AS n, AVG(age) AS mean_age "
                  "FROM patient_info",
    "group_by": "SELECT gender, COUNT(*) AS n FROM patient_info "
                "GROUP BY gender",
    "order_limit": "SELECT pid, age FROM patient_info ORDER BY age DESC "
                   "LIMIT 5",
    "between_case": "SELECT pid, CASE WHEN age BETWEEN 30 AND 40 THEN 1 "
                    "ELSE 0 END AS mid FROM patient_info",
    "shared_predict": "SELECT pid, PREDICT(MODEL='los') AS los FROM "
                      "patient_info JOIN blood_tests ON pid WHERE "
                      "PREDICT(MODEL='los') > 5",
    "pregnant_filter": "SELECT pid, PREDICT(MODEL='los') AS los FROM "
                       "patient_info JOIN blood_tests ON pid "
                       "WHERE pregnant = 1",
    "model_in_predicate": "SELECT pid FROM patient_info JOIN blood_tests "
                          "ON pid WHERE PREDICT(MODEL='los') > 6 "
                          "AND age > 40",
    "three_way_join": "SELECT pid, PREDICT(MODEL='los') AS los FROM "
                      "patient_info JOIN blood_tests ON pid JOIN "
                      "prenatal_tests ON pid WHERE rcount > 1",
    "join_elimination": "SELECT pid, PREDICT(MODEL='los') AS los FROM "
                        "patient_info JOIN blood_tests ON pid JOIN "
                        "prenatal_tests ON pid",
    "pruning": "SELECT pid, PREDICT(MODEL='los') AS los FROM patient_info "
               "JOIN blood_tests ON pid WHERE pregnant = 1 AND age > 35",
    "constant_folding": "SELECT pid FROM patient_info WHERE 1 = 1 "
                        "AND age > 200",
    "external": "SELECT pid, PREDICT(MODEL='los_ext') AS los FROM "
                "patient_info JOIN blood_tests ON pid LIMIT 50",
    "one_hot_pruning": "SELECT origin, PREDICT_PROBA(MODEL='delay') AS p "
                       "FROM flights WHERE dest = 3",
}

CONFIGS = {   # tests/test_optimizer_rules.py, strategy forced below
    "all_rules": {},
    "pruning_only": dict(enable_projection_pushdown=False,
                         enable_join_elimination=False,
                         enable_model_inlining=False,
                         enable_nn_translation=False),
    "pushdown_only": dict(enable_model_pruning=False,
                          enable_model_inlining=False,
                          enable_nn_translation=False),
    "inlining": dict(inline_max_nodes=100_000, enable_nn_translation=False),
    "nn_translation": dict(enable_model_inlining=False,
                           nn_translate_single_trees="always",
                           gemm_pad_to=16),
    "splitting": dict(enable_model_query_splitting=True, split_imbalance=0.95,
                      enable_model_inlining=False,
                      enable_nn_translation=False),
}

_CASES = [(c, "traversal") for c in CONFIGS] + \
    [("nn_translation", "gemm"), ("nn_translation", "pallas"),
     ("all_rules", "pallas")]


def _entries(report, port):
    out = []
    for rule, detail in report.entries:
        if rule == "tree_strategy" or "measured crossover" in detail:
            continue
        detail = re.sub(r"\b([a-z]+(?:_[a-z]+)*)_\d+\b", r"\1_#", detail)
        out.append((rule, detail if port else detail.replace("pallas",
                                                             "cuda")))
    return out


def _shape(plan):
    """Node ops and edges, independent of node ids."""
    order = plan.topo_order()
    pos = {nid: i for i, nid in enumerate(order)}
    return [(plan.nodes[n].op, tuple(pos[i] for i in plan.nodes[n].inputs),
             plan.nodes[n].runtime) for n in order], pos[plan.output]


def _same_result(jout, tout):
    assert sorted(tout.columns) == sorted(jout.columns)
    np.testing.assert_array_equal(tout.valid.numpy(), np.asarray(jout.valid))
    for name in jout.columns:
        want, got = np.asarray(jout.columns[name]), \
            tout.columns[name].numpy()
        assert got.dtype == want.dtype, name
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("cfg_name,strategy", _CASES,
                         ids=[f"{c}-{s}" for c, s in _CASES])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_same_rules_same_plan(stores, query, cfg_name, strategy):
    jstore, tstore = stores
    sql = QUERIES[query]
    cfg = CONFIGS[cfg_name]
    jplan, jrep = jcore.CrossOptimizer(jstore, jcore.OptimizerConfig(
        tree_strategy=strategy, **cfg)).optimize(jcore.parse_query(sql,
                                                                   jstore))
    port_strategy = "cuda" if strategy == "pallas" else strategy
    tplan, trep = tcore.CrossOptimizer(tstore, tcore.OptimizerConfig(
        tree_strategy=port_strategy, **cfg)).optimize(
            tcore.parse_query(sql, tstore))
    assert _entries(trep, True) == _entries(jrep, False)
    assert _shape(tplan) == _shape(jplan)
    assert trep.partitions == jrep.partitions
    _same_result(jcore.execute(jplan, jstore), tcore.execute(tplan, tstore))


def test_parse_errors_match():
    class Empty:
        def get_model(self, name):
            raise KeyError(name)
    for sql in ("SELECT FROM x", "SELECT a FROM t WHERE"):
        with pytest.raises(jcore.SqlError) as jerr:
            jcore.parse_query(sql, Empty())
        with pytest.raises(tcore.SqlError) as terr:
            tcore.parse_query(sql, Empty())
        assert str(terr.value) == str(jerr.value)
        assert terr.value.pos == jerr.value.pos


def test_fingerprint_reads_tensors_by_bytes():
    """Content digests (plan signatures) read a tensor through the host, so
    the same bytes give the same digest as the numpy array."""
    from repro.core.model_store import content_fingerprint as jfp
    from repro_torch.core.model_store import content_fingerprint as tfp
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert tfp(torch.from_numpy(arr)) == tfp(arr) == jfp(arr)
    assert tfp(torch.from_numpy(arr + 1)) != tfp(arr)


def test_cuda_strategy_costs_inf_off_the_card(stores):
    from repro_torch.core.cost_model import (backend_of,
                                             calibrated_tree_costs,
                                             tree_strategy_costs)
    _, tstore = stores
    assert backend_of(tstore) == "cpu"
    cal = calibrated_tree_costs(catalog=tstore)
    assert cal.backend == "cpu" and cal.cuda_flop is None
    assert tstore.get_calibration(("tree_strategy", "cpu")) is cal
    model = tstore.get_model("los").model
    costs = tree_strategy_costs(model, 1e6, 7, cal)
    assert costs["cuda"] == float("inf")
    assert 0 < costs["traversal"] < float("inf")


def test_slot_estimate_counts_masked_rows(stores):
    """A filter masks rows without dropping slots: the slot estimate (the
    card's strategy pricing) keeps the scan's capacity where the live-row
    estimate applies the predicate's selectivity."""
    from repro_torch.core.cost_model import estimate_rows, estimate_slots
    _, tstore = stores
    plan = tcore.parse_query("SELECT pid, PREDICT(MODEL='los') AS los FROM "
                             "patient_info JOIN blood_tests ON pid "
                             "WHERE pregnant = 1", tstore)
    rows, slots = estimate_rows(plan, tstore), estimate_slots(plan, tstore)
    assert slots[plan.output] == 4000.0
    assert rows[plan.output] < 4000.0


def test_cpu_calibration_stays_on_the_stand_in_forest(stores):
    """Only the card calibrates per model: on the CPU a model argument
    changes nothing, so every CPU choice keeps its one calibration."""
    from repro_torch.core.cost_model import calibrated_tree_costs
    _, tstore = stores
    model = tstore.get_model("los").model
    cal = calibrated_tree_costs(catalog=tstore)
    assert calibrated_tree_costs(catalog=tstore, model=model) is cal
    assert [k for k in tstore._calibrations if k[0] == "tree_strategy"] == \
        [("tree_strategy", "cpu")]
