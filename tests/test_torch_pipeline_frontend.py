"""The port's Python-pipeline frontend (``core/pipeline_frontend.py``)
against the JAX package's: the pipeline cases of ``tests/test_frontends.py``
run on the port, and the same scripts and pipelines go through both
packages' ``analyze_script`` / ``trace_pipeline`` over catalogs holding the
same tables (4,000 patients, seed 7) and the same fitted pipeline (fitted
by the JAX package, carried across as numpy state).  The plans must have
equal ``plan_signature``s, the same UDF fallbacks, and execute to the same
answers bitwise.
"""

import numpy as np
import pytest

from repro import core as jcore
from repro.core.ir import plan_signature as jsig
from repro_torch import core as tcore
from repro_torch.core.ir import Category, Plan
from repro_torch.core.ir import plan_signature as tsig
from repro_torch.data import hospital_tables as thospital
from repro_torch.ml.convert import pipeline_from_state, pipeline_state

SCRIPTS = {
    "full_pipeline": """
df = load_table('patient_info')
bt = load_table('blood_tests')
df = df.merge(bt, on='pid')
df = df[(df['pregnant'] == 1) & (df['age'] > 25)]
pred = model.predict(df)
df['los'] = pred
df = df[df['los'] > 5]
""",
    "attribute_access": """
df = load_table('patient_info')
df = df[df.age > 60]
""",
    "loop_udf": """
df = load_table('patient_info')
for i in range(3):
    df = df
""",
    "computed_column": """
df = load_table('patient_info')
df['age2'] = df['age'] * 2 + 1
""",
    "transform_then_predict": """
df = load_table('patient_info')
bt = load_table('blood_tests')
df = df.merge(bt, on='pid')
pred = model.predict(df)
df['los'] = pred
""",
}


@pytest.fixture(scope="module")
def stores(hospital_tree):
    """(jax store, port store, jax pipeline, port pipeline): the conftest's
    ``hospital_tree`` (4,000 patients, seed 7, the ``los`` tree) and the
    port's catalog over the same tables with that tree carried across."""
    jstore, data, jpipe = hospital_tree
    tstore = tcore.ModelStore(device="cpu")
    for name, t in thospital(4000, seed=7).items():
        tstore.register_table(name, t)
    tpipe = pipeline_from_state(pipeline_state(jpipe))
    tstore.register_model("los", tpipe)
    return jstore, tstore, jpipe, tpipe, data


def _same(jout, tout):
    assert sorted(tout.columns) == sorted(jout.columns)
    np.testing.assert_array_equal(tout.valid.numpy(), np.asarray(jout.valid))
    for name in jout.columns:
        want, got = np.asarray(jout.columns[name]), \
            tout.columns[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# -- the reference's pipeline cases, on the port -----------------------------

def test_analyze_script_full_pipeline(stores):
    _, store, _, pipe, _ = stores
    plan, n_udf = tcore.analyze_script(SCRIPTS["full_pipeline"], store,
                                       objects={"model": pipe})
    assert n_udf == 0
    out = tcore.execute(plan, store).to_pydict()
    assert len(out["pid"]) > 0
    assert all(v > 5 for v in out["los"])
    # cross-check against the SQL route
    sql_plan = tcore.parse_query(
        "SELECT * FROM patient_info JOIN blood_tests ON pid "
        "WHERE pregnant = 1 AND age > 25 AND PREDICT(MODEL='los') > 5",
        store)
    sql_out = tcore.execute(sql_plan, store).to_pydict()
    assert sorted(sql_out["pid"]) == sorted(out["pid"])


def test_analyze_script_attribute_access(stores):
    _, store, _, _, _ = stores
    plan, _ = tcore.analyze_script(SCRIPTS["attribute_access"], store)
    out = tcore.execute(plan, store).to_pydict()
    assert out["age"] and all(a > 60 for a in out["age"])


def test_analyze_script_loop_falls_back_to_udf(stores):
    _, store, _, _, _ = stores
    _, n_udf = tcore.analyze_script(SCRIPTS["loop_udf"], store)
    assert n_udf == 1      # the loop became an opaque UDF (paper §3.2)


def test_analyze_script_computed_column(stores):
    _, store, _, _, data = stores
    plan, _ = tcore.analyze_script(SCRIPTS["computed_column"], store)
    out = tcore.execute(plan, store).to_pydict()
    assert np.allclose(out["age2"], (data["age"] * 2 + 1).tolist())


def test_unsupported_expression_raises_in_both_packages(stores):
    from repro.core.pipeline_frontend import StaticAnalysisError as JError
    from repro_torch.core.pipeline_frontend import StaticAnalysisError
    jstore, tstore, _, _, _ = stores
    src = "df = load_table('patient_info')\ndf['z'] = mystery(df)\n"
    with pytest.raises(JError) as jerr:
        jcore.analyze_script(src, jstore)
    with pytest.raises(StaticAnalysisError) as terr:
        tcore.analyze_script(src, tstore)
    assert str(terr.value) == str(jerr.value)


# -- the two packages side by side -------------------------------------------

@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_analyze_script_matches_jax(stores, name):
    jstore, tstore, jpipe, tpipe, _ = stores
    jplan, j_udf = jcore.analyze_script(SCRIPTS[name], jstore,
                                        objects={"model": jpipe})
    tplan, t_udf = tcore.analyze_script(SCRIPTS[name], tstore,
                                        objects={"model": tpipe})
    assert t_udf == j_udf
    assert tsig(tplan) == jsig(jplan)
    assert [n.op for n in map(tplan.nodes.get, tplan.topo_order())] == \
        [n.op for n in map(jplan.nodes.get, jplan.topo_order())]
    if name != "loop_udf":
        _same(jcore.execute(jplan, jstore), tcore.execute(tplan, tstore))


@pytest.mark.parametrize("proba", [False, True])
def test_trace_pipeline_matches_jax(stores, proba):
    """``trace_pipeline`` expands a fitted pipeline into featurize ->
    predict_model -> attach_column the same way in both packages."""
    from repro.core.ir import Category as JCategory
    from repro.core.ir import Plan as JPlan
    jstore, tstore, jpipe, tpipe, _ = stores
    jplan, tplan = JPlan(), Plan()

    def joined(plan, cat):
        a = plan.emit("scan", cat.RA, [], "table", table="patient_info")
        b = plan.emit("scan", cat.RA, [], "table", table="blood_tests")
        return plan.emit("join", cat.RA, [a, b], "table", on="pid",
                         how="inner")

    jscan, tscan = joined(jplan, JCategory), joined(tplan, Category)
    jplan.output = jcore.trace_pipeline(jplan, jscan, jpipe, "los", "p",
                                        proba=proba)
    tplan.output = tcore.trace_pipeline(tplan, tscan, tpipe, "los", "p",
                                        proba=proba)
    assert tsig(tplan) == jsig(jplan)
    assert sorted(n.op for n in tplan.nodes.values()) == \
        ["attach_column", "featurize", "join", "predict_model", "scan",
         "scan"]
    if not proba:    # a regression tree: PREDICT_PROBA is not meaningful
        _same(jcore.execute(jplan, jstore), tcore.execute(tplan, tstore))


def test_script_and_sql_routes_agree_after_optimization(stores):
    """The script route and the SQL route select the same rows once
    optimized."""
    _, store, _, pipe, _ = stores
    splan, _ = tcore.analyze_script(SCRIPTS["full_pipeline"], store,
                                    objects={"model": pipe})
    qplan = tcore.parse_query(
        "SELECT * FROM patient_info JOIN blood_tests ON pid "
        "WHERE pregnant = 1 AND age > 25 AND PREDICT(MODEL='los') > 5",
        store)
    cfg = tcore.OptimizerConfig(tree_strategy="traversal")
    so, _ = tcore.CrossOptimizer(store, cfg).optimize(splan)
    qo, _ = tcore.CrossOptimizer(store, cfg).optimize(qplan)
    _same_port(tcore.execute(so, store), tcore.execute(qo, store))


def _same_port(a, b):
    va, vb = a.valid.numpy(), b.valid.numpy()
    pa = np.sort(a.columns["pid"].numpy()[va])
    pb = np.sort(b.columns["pid"].numpy()[vb])
    np.testing.assert_array_equal(pa, pb)
