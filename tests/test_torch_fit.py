"""The port's own fits (``LinearRegression``, ``LogisticRegression``,
``MLP`` and ``Pipeline.fit`` on ``torch.autograd``) against the JAX
package's ``jax.grad`` fits on the same numpy inputs, on the CPU.

Tolerances: linear and logistic weights and bias within 1e-6 absolute with
equal sets of zero weights (the two packages sum the gradients in another
order; measured within 1.3e-7); the MLP's parameters within rtol 1e-5 /
atol 1e-6 from JAX's initial parameters (``jax.random``'s draws cannot be
reproduced, so the test carries them across by replacing ``_init`` on the
port's instance), and equal predictions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import ml as jml
from repro_torch import ml as tml

LIN_ATOL = 1e-6
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6


def _sparse_logistic_data():
    # tests/test_ml_models.py::test_l1_logistic_sparsity_monotone's data
    rng = np.random.default_rng(1)
    x = rng.normal(size=(600, 30)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
    return x, y


def _regression_data():
    # tests/test_ml_models.py::test_linear_regression_recovers_weights's
    rng = np.random.default_rng(2)
    x = rng.normal(size=(800, 6)).astype(np.float32)
    w_true = np.asarray([2.0, -1.0, 0.0, 0.0, 0.5, 0.0], np.float32)
    return x, x @ w_true + 3.0, w_true


def _toy(n=400, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    return x, y


def _assert_linear_close(tm, jm):
    np.testing.assert_allclose(tm.weights, np.asarray(jm.weights),
                               rtol=0, atol=LIN_ATOL)
    assert abs(tm.bias - jm.bias) <= LIN_ATOL
    assert tm.weights.dtype == np.float32
    np.testing.assert_array_equal(tm.zero_weight_features(),
                                  jm.zero_weight_features())


@pytest.mark.parametrize("l1", [0.001, 0.05, 0.2])
def test_logistic_fit_matches_jax(l1):
    x, y = _sparse_logistic_data()
    jm = jml.LogisticRegression(l1=l1, steps=200).fit(x, y)
    tm = tml.LogisticRegression(l1=l1, steps=200).fit(x, y, device="cpu")
    _assert_linear_close(tm, jm)


def test_linear_regression_fit_matches_jax():
    x, y, _ = _regression_data()
    jm = jml.LinearRegression(l1=0.01, steps=600, lr=0.2).fit(x, y)
    tm = tml.LinearRegression(l1=0.01, steps=600, lr=0.2).fit(
        x, y, device="cpu")
    _assert_linear_close(tm, jm)


def test_one_step_bias_pins_abs_derivative_at_zero():
    """At the first step every logit is 0; JAX differentiates |z| there as
    1 (torch's ``abs`` as 0), which moves the bias by lr / 2."""
    x, y = _sparse_logistic_data()
    jm = jml.LogisticRegression(l1=0.0, steps=1).fit(x, y)
    tm = tml.LogisticRegression(l1=0.0, steps=1).fit(x, y, device="cpu")
    assert abs(tm.bias - jm.bias) <= 1e-7
    np.testing.assert_allclose(tm.weights, np.asarray(jm.weights),
                               rtol=0, atol=1e-7)


def test_flights_pipeline_fit_matches_jax(flights):
    """The ``flights`` fixture's 4,000-row pipeline, fitted by each
    package: one-hot origin/dest/carrier, the scaler, L1 logistic."""
    _, fcols, fy, jpipe = flights
    tpipe = tml.Pipeline(
        [tml.OneHotEncoder(["origin", "dest", "carrier"]),
         tml.StandardScaler(["distance", "taxi_out", "dep_hour"])],
        tml.LogisticRegression(l1=0.01, steps=150),
        tml.PipelineMetadata(name="delay", task="classification"))
    tpipe.fit(fcols, fy, device="cpu")
    _assert_linear_close(tpipe.model, jpipe.model)
    assert tpipe.model.feature_names == jpipe.model.feature_names


def _mlp_pair(task, n_outputs, hidden=(16, 8), steps=40, lr=1e-2):
    jm = jml.MLP(hidden=hidden, n_outputs=n_outputs, task=task, steps=steps,
                 lr=lr)
    tm = tml.MLP(hidden=hidden, n_outputs=n_outputs, task=task, steps=steps,
                 lr=lr)
    return jm, tm


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_mlp_fit_matches_jax_from_its_initial_parameters(task):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    if task == "classification":
        y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.int32)
    else:
        y = (x[:, 0] - 2 * x[:, 3]).astype(np.float32)
    jm, tm = _mlp_pair(task, 2 if task == "classification" else 1)
    init = [{k: np.array(v) for k, v in p.items()} for p in jm._init(6)]
    tm._init = lambda d_in: init
    jm.fit(x, y)
    tm.fit(x, y, device="cpu")
    for tp, jp in zip(tm.params, jm.params):
        for k in ("w", "b"):
            assert tp[k].dtype == np.float32
            np.testing.assert_allclose(tp[k], np.asarray(jp[k]),
                                       rtol=MLP_RTOL, atol=MLP_ATOL)
    got = tm.predict(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.predict(jnp.asarray(x)))
    if task == "classification":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=MLP_RTOL, atol=MLP_ATOL)


def test_mlp_init_is_he_normal_from_its_seed():
    m = tml.MLP(hidden=(64, 32), n_outputs=2, seed=4)
    a, b = m._init(300), m._init(300)
    assert [tuple(p["w"].shape) for p in a] == [(300, 64), (64, 32),
                                                 (32, 2)]
    for pa, pb in zip(a, b):
        assert torch.equal(pa["w"], pb["w"])
        assert not pa["b"].any()
    assert abs(float(a[0]["w"].std()) - np.sqrt(2.0 / 300)) < 0.01
    c = tml.MLP(hidden=(64, 32), n_outputs=2, seed=5)._init(300)
    assert not torch.equal(a[0]["w"], c[0]["w"])


# -- the reference's own checks, on the port's fits --------------------------

def test_l1_logistic_sparsity_monotone():
    x, y = _sparse_logistic_data()
    s = []
    for l1 in (0.001, 0.05, 0.2):
        lr = tml.LogisticRegression(l1=l1, steps=200).fit(x, y,
                                                          device="cpu")
        s.append(lr.sparsity())
    assert s[0] <= s[1] <= s[2]
    assert s[2] > 0.5


def test_linear_regression_recovers_weights():
    x, y, w_true = _regression_data()
    lr = tml.LinearRegression(l1=0.01, steps=600, lr=0.2).fit(
        x, y, device="cpu")
    assert np.allclose(lr.weights, w_true, atol=0.15)
    assert abs(lr.bias - 3.0) < 0.2
    assert set(lr.zero_weight_features()) >= {2, 3}


def test_mlp_restrict_features_consistent():
    x, y = _toy(300, d=6)
    mlp = tml.MLP(hidden=(16,), n_outputs=2, steps=40).fit(x, y,
                                                           device="cpu")
    keep = np.asarray([0, 1, 3])
    sub = mlp.restrict_features(keep)
    got = sub.predict_scores(torch.from_numpy(x[:, keep])).numpy()
    # restriction zero-imputes dropped features
    x0 = x.copy()
    x0[:, [2, 4, 5]] = 0.0
    ref = mlp.predict_scores(torch.from_numpy(x0)).numpy()
    assert np.allclose(got, ref, atol=1e-4)


# -- devices -----------------------------------------------------------------

def test_fit_keeps_a_tensors_device_and_state_round_trips():
    """A tensor input fits on its own device; the fitted state is numpy
    float32 and carries through ``convert`` unchanged."""
    from repro_torch.ml.convert import model_from_state, model_state
    x, y = _toy(200, d=4, seed=2)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    lr = tml.LogisticRegression(l1=0.01, steps=30).fit(tx, ty.float())
    mlp = tml.MLP(hidden=(8,), steps=10).fit(tx, ty)
    for m in (lr, mlp):
        back = model_from_state(model_state(m))
        np.testing.assert_array_equal(back.predict(tx).numpy(),
                                      m.predict(tx).numpy())
    assert isinstance(mlp.params[0]["w"], np.ndarray)


@pytest.mark.parametrize("make", [
    lambda: tml.LogisticRegression(steps=2),
    lambda: tml.LinearRegression(steps=2),
    lambda: tml.MLP(hidden=(4,), steps=2),
], ids=["logistic", "linear", "mlp"])
def test_pipeline_fit_runs_on_the_card_or_raises(make):
    """``Pipeline.fit`` of a linear or MLP model runs on the card unless
    the caller asks for the CPU; with no card it raises (no quiet CPU
    fallback)."""
    x, y = _toy(20, d=3)
    data = {"a": x[:, 0], "b": x[:, 1]}
    pipe = tml.Pipeline([tml.StandardScaler(["a", "b"])], make())
    if torch.cuda.is_available():
        pipe.fit(data, y)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipe.fit(data, y)
    pipe.fit(data, y, device="cpu")
    assert pipe.predict({k: torch.from_numpy(v)
                         for k, v in data.items()}).shape == (20,)


def test_tree_pipeline_fit_stays_numpy_without_a_device():
    """Tree models keep their numpy CART fit: no device needed."""
    x, y = _toy(200, d=3)
    data = {"a": x[:, 0], "b": x[:, 1], "c": x[:, 2]}
    pipe = tml.Pipeline([tml.StandardScaler(["a", "b", "c"])],
                        tml.DecisionTree(max_depth=3))
    pipe.fit(data, y)
    assert pipe.model.tree.n_nodes > 1
