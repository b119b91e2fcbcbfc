"""The port's model clustering (``repro_torch.core.clustering``, paper
§4.1, Fig 2b) against the JAX package's on the same numpy inputs, on the
CPU.  Both k-means start from JAX's initial rows (``init_idx``:
``jax.random.choice(PRNGKey(seed), n, (k,), replace=False)``, the draw the
JAX package makes), so the assignments are equal and the centroids within
1e-6; the pipelines are fitted once by the JAX package and carried across
(``ml.convert``), so each cluster's specialized model is equal too."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import ml as jml
from repro.core import clustering as jcl
from repro_torch.core import clustering as tcl
from repro_torch.ml.convert import pipeline_from_state, pipeline_state

CENT_ATOL = 1e-6
CLUSTER_COLS = ["origin", "dest", "carrier"]


def _jax_init(n, k, seed=0):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=False))


def test_kmeans_separates_blobs():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(50, 2)) + 10
    b = rng.normal(size=(50, 2)) - 10
    x = torch.as_tensor(np.vstack([a, b]), dtype=torch.float32)
    cents, assign = tcl.kmeans(x, 2, seed=1)
    assert cents.dtype == torch.float32 and assign.dtype == torch.int64
    assign = assign.numpy()
    assert len(set(assign[:50])) == 1
    assert len(set(assign[50:])) == 1
    assert assign[0] != assign[-1]


def _blobs():
    rng = np.random.default_rng(0)
    return np.vstack([rng.normal(size=(50, 2)) + 10,
                      rng.normal(size=(50, 2)) - 10]).astype(np.float32)


def _codes():
    from repro.data import flight_features
    fcols, _ = flight_features(3000, seed=3)
    return np.stack([fcols[c] for c in CLUSTER_COLS], 1).astype(np.float32)


def _normal():
    return (np.random.default_rng(4).normal(size=(3000, 3)) * 3).astype(
        np.float32)


@pytest.mark.parametrize("data,k,seed", [
    (_blobs, 2, 1), (_codes, 4, 0), (_codes, 16, 2), (_normal, 8, 5)],
    ids=["blobs-k2", "codes-k4", "codes-k16", "normal-k8"])
def test_kmeans_matches_jax_from_its_initial_rows(data, k, seed):
    x = data()
    jc, ja = jcl.kmeans(jnp.asarray(x), k, seed=seed)
    tc, ta = tcl.kmeans(torch.from_numpy(x), k,
                        init_idx=_jax_init(x.shape[0], k, seed))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=CENT_ATOL)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def _constraints(cl, sample, assign, k):
    return [[(c.column, c.kind, c.value)
             for c in cl._cluster_constraints(sample, assign, cid)]
            for cid in range(k)]


def _both(jpipe, fcols, k=4, n_sample=1500):
    sample = {c: v[:n_sample] for c, v in fcols.items()}
    tpipe = pipeline_from_state(pipeline_state(jpipe))
    jcm = jcl.build_clustered_model(jpipe, sample, k=k,
                                    cluster_columns=CLUSTER_COLS)
    tcm = tcl.build_clustered_model(tpipe, sample, k=k,
                                    cluster_columns=CLUSTER_COLS,
                                    init_idx=_jax_init(n_sample, k),
                                    device="cpu")
    return sample, jcm, tcm


def test_clustered_model_matches_jax(flights):
    """The ``flights`` fixture's logistic pipeline, k = 4 over a 1,500-row
    sample: equal constraints, features and model cost per cluster, and
    routed labels equal to the JAX package's on every row."""
    _, fcols, _, jpipe = flights
    sample, jcm, tcm = _both(jpipe, fcols)
    np.testing.assert_allclose(tcm.centroids, jcm.centroids, rtol=0,
                               atol=CENT_ATOL)
    x = np.stack([sample[c] for c in CLUSTER_COLS], 1).astype(np.float32)
    ja = np.asarray(jcm.assign({c: jnp.asarray(x[:, i])
                                for i, c in enumerate(CLUSTER_COLS)}))
    ta = tcm.assign({c: torch.from_numpy(x[:, i])
                     for i, c in enumerate(CLUSTER_COLS)}).numpy()
    np.testing.assert_array_equal(ta, ja)
    cc = {c: sample[c] for c in CLUSTER_COLS}
    assert _constraints(tcl, cc, ta, 4) == _constraints(jcl, cc, ja, 4)
    assert [e.n_features for e in tcm.entries] == \
        [e.n_features for e in jcm.entries]
    assert tcm.model_cost() == jcm.model_cost()
    for te, je in zip(tcm.entries, jcm.entries):
        np.testing.assert_array_equal(te.model.weights, je.model.weights)
        assert te.model.bias == je.model.bias

    tcols = {c: torch.from_numpy(v) for c, v in fcols.items()}
    jcols = {c: jnp.asarray(v) for c, v in fcols.items()}
    routed = tcm.predict_routed(tcols)
    assert routed.dtype == torch.float32 and routed.shape == (4000,)
    np.testing.assert_array_equal(routed.numpy(), jcm.predict_routed(jcols))
    full = tcm.pipeline.predict(tcols).numpy()
    assert (full == routed.numpy()).mean() >= 0.999
    cost = tcm.model_cost()
    assert cost["mean_cluster_features"] <= cost["original_features"]


def test_decision_tree_clusters_prune_like_jax(flights):
    """A decision-tree pipeline: each cluster's pruned, feature-restricted
    ``TreeArrays`` equals the JAX package's field by field."""
    _, fcols, fy, _ = flights
    jpipe = jml.Pipeline(
        [jml.OneHotEncoder(["origin", "dest", "carrier"]),
         jml.StandardScaler(["distance", "taxi_out", "dep_hour"])],
        jml.DecisionTree(task="classification", max_depth=6, min_leaf=10),
        jml.PipelineMetadata(name="delay_dt"))
    jpipe.fit(fcols, fy)
    _, jcm, tcm = _both(jpipe, fcols)
    for te, je in zip(tcm.entries, jcm.entries):
        assert te.n_features == je.n_features
        assert [f.mapping().names for f in te.featurizers] == \
            [f.mapping().names for f in je.featurizers]
        for field in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(te.model.tree, field),
                                          getattr(je.model.tree, field))
        assert (te.model.tree.depth, te.model.tree.n_features) == \
            (je.model.tree.depth, je.model.tree.n_features)
    assert any(e.n_features < tcm.model_cost()["original_features"]
               for e in tcm.entries)
    tcols = {c: torch.from_numpy(v) for c, v in fcols.items()}
    jcols = {c: jnp.asarray(v) for c, v in fcols.items()}
    np.testing.assert_array_equal(tcm.predict_routed(tcols).numpy(),
                                  jcm.predict_routed(jcols))


def test_register_clustered_writes_an_audit_entry(flights):
    from repro_torch.core import ModelStore
    _, fcols, _, jpipe = flights
    _, _, tcm = _both(jpipe, fcols, k=2, n_sample=400)
    store = ModelStore(device="cpu")
    assert store.get_clustered("delay") is None
    store.register_clustered("delay", tcm)
    assert store.get_clustered("delay") is tcm
    rec = store.audit_log[-1]
    assert (rec.action, rec.subject) == ("cluster", "delay")


def test_build_clustered_model_runs_on_the_card_or_raises(flights):
    _, fcols, _, jpipe = flights
    tpipe = pipeline_from_state(pipeline_state(jpipe))
    sample = {c: v[:200] for c, v in fcols.items()}
    if torch.cuda.is_available():
        cm = tcl.build_clustered_model(tpipe, sample, k=2,
                                       cluster_columns=CLUSTER_COLS)
        assert cm.centroids.shape == (2, 3)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcl.build_clustered_model(tpipe, sample, k=2,
                                      cluster_columns=CLUSTER_COLS)
