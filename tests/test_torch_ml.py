"""The port's ``ml`` layer against the JAX package's, on models the JAX
package fitted and carried across as numpy state (``repro_torch.ml.convert``).

Tree inference is held **bitwise** for every strategy: traversal, the dense
GEMM lowering at pad 8 and 128, and the kernel strategy (the port's plain
version on CPU tensors vs the JAX wrapper in interpret mode).  The JAX side
runs jitted, as its plan path does; XLA then turns the forest's final
divide-by-``n_trees`` into a multiply by the float32 reciprocal, and the
port averages that way too, so no ulp of slack is needed.

Featurizers, linear and MLP inference are held with ``allclose(rtol=1e-6)``:
their products and sums go through XLA's and torch's own float32 kernels,
which may order a dot product's additions differently (a few ulp).  The
linear and MLP outputs add ``atol=1e-6`` for outputs near zero, where a
relative bound says nothing after cancellation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import ml as jml
from repro.kernels.tree_gemm import ops as jax_tg
from repro_torch import ml as tml
from repro_torch.kernels.tree_gemm import ops as tg_ops
from repro_torch.ml.convert import (model_from_state, model_state,
                                    pipeline_from_state, pipeline_state)


def _data(seed, n_features, n_rows, nan_frac):
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(300, n_features)).astype(np.float32)
    y = (xf[:, 0] + 0.5 * xf[:, -1] > 0).astype(np.int32)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    if nan_frac:
        x[rng.random(x.shape) < nan_frac] = np.nan
        x[rng.random(x.shape) < nan_frac / 2] = np.inf
        x[rng.random(x.shape) < nan_frac / 2] = -np.inf
    return xf, y, x


_MODELS = {
    "forest": lambda xf, y: jml.RandomForest(
        n_trees=5, max_depth=6, min_leaf=2, seed=3).fit(xf, y),
    "forest_1tree": lambda xf, y: jml.RandomForest(
        n_trees=1, max_depth=4, seed=1).fit(xf, y),
    "tree_cls": lambda xf, y: jml.DecisionTree(
        task="classification", max_depth=6, min_leaf=3).fit(xf, y),
    "tree_reg": lambda xf, y: jml.DecisionTree(
        task="regression", max_depth=5).fit(xf, xf[:, 1] * 2.0 + y),
    "gbt": lambda xf, y: jml.GradientBoostedTrees(
        n_trees=7, max_depth=3).fit(xf, xf[:, 0] - xf[:, 2] + y),
}


def _trees(model):
    return [model.tree] if model.kind == "decision_tree" else model.trees


def _jax_scores(model):
    return model.predict if model.kind == "gbt" else model.predict_scores


def _port_scores(model):
    return model.predict if model.kind == "gbt" else model.predict_scores


def _pair(name, seed, nan_frac):
    xf, y, x = _data(seed, 6, 97, nan_frac)
    jm = _MODELS[name](xf, y)
    return jm, model_from_state(model_state(jm)), x


@pytest.mark.parametrize("nan_frac", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_traversal_bitwise(name, nan_frac):
    jm, tm, x = _pair(name, 11, nan_frac)
    want = np.asarray(jax.jit(_jax_scores(jm))(jnp.asarray(x)))
    got = _port_scores(tm)(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nan_frac", [0.0, 0.2])
def test_tree_arrays_traversal_bitwise(nan_frac):
    """``TreeArrays.predict_torch`` against ``predict_jnp``, tree by tree."""
    jm, tm, x = _pair("forest", 14, nan_frac)
    for jt, tt in zip(jm.trees, tm.trees):
        want = np.asarray(jax.jit(jt.predict_jnp)(jnp.asarray(x)))
        np.testing.assert_array_equal(
            tt.predict_torch(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("pad", [8, 128])
@pytest.mark.parametrize("nan_frac", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_dense_gemm_bitwise(name, nan_frac, pad):
    jm, tm, x = _pair(name, 12, nan_frac)
    average = jm.kind != "gbt"
    jens = jml.ensemble_to_gemm(_trees(jm), pad_to=pad, average=average)
    tens = tml.ensemble_to_gemm(_trees(tm), pad_to=pad, average=average)
    want = np.asarray(jax.jit(
        lambda v: jml.predict_ensemble_gemm(jens, v))(jnp.asarray(x)))
    got = tml.predict_ensemble_gemm(tens, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nan_frac", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_kernel_strategy_bitwise(name, nan_frac):
    jm, tm, x = _pair(name, 13, nan_frac)
    average = jm.kind != "gbt"
    jens = jml.ensemble_to_gemm(_trees(jm), pad_to=128, average=average)
    tens = tml.ensemble_to_gemm(_trees(tm), pad_to=128, average=average)
    want = np.asarray(jax_tg.tree_gemm(jens, jnp.asarray(x), interpret=True))
    got = tg_ops.tree_gemm(tens, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if average:     # and the strategies agree with traversal in the port
        np.testing.assert_array_equal(
            got, _port_scores(tm)(torch.from_numpy(x)).numpy())


def _hospital_columns(seed=5, n=400):
    from repro.data import hospital_features
    cols, label = hospital_features(n, seed=seed)
    cols = {k: v for k, v in cols.items()}
    cols["hematocrit"] = cols["hematocrit"].copy()
    cols["hematocrit"][::17] = np.nan          # something to impute
    return cols, label


def _featurizers(cols):
    return [
        jml.StandardScaler(["age", "bp", "neutrophils"]).fit(cols),
        jml.OneHotEncoder(["gender", "rcount"]).fit(cols),
        jml.Imputer(["hematocrit"]).fit(cols),
        jml.Imputer(["hematocrit"], strategy="median").fit(cols),
        jml.Bucketizer("age", [30.0, 45.0, 60.0, 75.0]),
        jml.Bucketizer("age", [30.0, 45.0, 60.0]).restrict([0, 2]),
        jml.OneHotEncoder(["rcount"]).fit(cols).restrict([0, 1, 3]),
    ]


@pytest.mark.parametrize("index", range(7))
def test_featurizers_allclose(index):
    cols, _ = _hospital_columns()
    jf = _featurizers(cols)[index]
    state = pipeline_state(jml.Pipeline([jf], jml.DecisionTree()
                                        .fit(np.zeros((20, 1)),
                                             np.zeros(20, np.int32))))
    tf = pipeline_from_state(state).featurizers[0]
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    tcols = {k: torch.from_numpy(np.array(v)) for k, v in cols.items()}
    want = np.asarray(jax.jit(jf.transform)(jcols))
    got = tf.transform(tcols).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    tm, jmp = tf.mapping(), jf.mapping()
    assert (tm.names, tm.source, tm.category) == \
        (jmp.names, jmp.source, jmp.category)


@pytest.fixture(scope="module")
def flight_models():
    from repro.data import flight_features
    cols, y = flight_features(600, seed=4)
    ohe = jml.OneHotEncoder(["origin", "carrier"]).fit(cols)
    sc = jml.StandardScaler(["distance", "taxi_out", "dep_hour"]).fit(cols)
    pipes = {
        "logistic": jml.Pipeline([ohe, sc], jml.LogisticRegression(
            l1=0.01, steps=60), jml.PipelineMetadata(name="lr")),
        "linear": jml.Pipeline([sc], jml.LinearRegression(steps=60),
                               jml.PipelineMetadata(name="lin",
                                                    task="regression")),
        "mlp": jml.Pipeline([ohe, sc], jml.MLP(hidden=(16, 8), steps=40),
                            jml.PipelineMetadata(name="mlp")),
    }
    for name, p in pipes.items():
        target = cols["taxi_out"] if name == "linear" else y
        p.fit(cols, target)
    return cols, pipes


@pytest.mark.parametrize("name", ["logistic", "linear", "mlp"])
def test_linear_and_mlp_inference_allclose(flight_models, name):
    cols, pipes = flight_models
    jp = pipes[name]
    tp = pipeline_from_state(pipeline_state(jp))
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
    want = np.asarray(jax.jit(jp.predict_scores)(jcols))
    got = tp.predict_scores(tcols).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name == "logistic":
        np.testing.assert_allclose(
            tp.model.predict_proba(tp.transform(tcols)).numpy(),
            np.asarray(jax.jit(lambda c: jp.model.predict_proba(
                jp.transform(c)))(jcols)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tp.model.zero_weight_features()
                                  if name != "mlp" else [],
                                  jp.model.zero_weight_features()
                                  if name != "mlp" else [])


def test_linear_and_mlp_fit_not_ported():
    """The fits are ported (``tests/test_torch_fit.py`` holds them against
    the JAX package): numpy data fits on the card, or raises without one
    unless the caller asks for the CPU."""
    x, y = np.zeros((4, 2)), np.zeros(4)
    for make in (tml.LogisticRegression, tml.MLP):
        if torch.cuda.is_available():
            make(steps=1).fit(x, y)
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(steps=1).fit(x, y)
        make(steps=1).fit(x, y, device="cpu")


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cart_fit_matches_jax_fit_bitwise(task):
    """The CART fitter is numpy in both packages: the same data and seed
    give the same trees, array for array.  (A whole ``Pipeline.fit`` can
    differ in a threshold's last ulp: the JAX package featurizes eagerly at
    fit time, dividing by the scaler's std, while the port featurizes as
    the jitted plans do, multiplying by its reciprocal.)"""
    xf, y, _ = _data(21, 5, 1, 0.0)
    target = y if task == "classification" else xf[:, 0] * 3.0 + y
    jrf = jml.RandomForest(n_trees=4, max_depth=5, task=task,
                           seed=2).fit(xf, target)
    trf = tml.RandomForest(n_trees=4, max_depth=5, task=task,
                           seed=2).fit(xf, target)
    for jt, tt in zip(jrf.trees, trf.trees):
        for field in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(tt, field),
                                          getattr(jt, field))
        assert tt.depth == jt.depth
