"""The plain reference on hand-worked cases of each query shape and model."""

import numpy as np
import pytest
import torch

from raven_bench.harness import layout
from raven_bench.reference import query

TOL = 1e-5


def _ref():
    return {"pid": np.arange(6, dtype=np.int32),
            "g": np.array([0, 1, 0, 1, 0, 1], np.int32),
            "x": np.array([5, 1, 4, 2, 3, 0], np.float32),
            "predict": np.array([1, 0, 1, 1, 0, 0], np.float64),
            "proba": np.array([.9, .2, .8, .6, .4, .1], np.float64)}


ROWS = {"kind": "rows", "filter": [["pid", ">=", ":lo"], ["pid", "<", ":hi"]],
        "columns": {"pid": "pid", "s": "predict"}}
GROUP = {"kind": "group_avg", "filter": [["proba", ">=", 0],
                                         ["x", ">=", ":t"]],
         "key": ["g", "g"], "avg": ["p", "proba"]}
TOP = {"kind": "top_k", "filter": [["pid", ">=", ":lo"], ["pid", "<", ":hi"]],
       "k": 2, "key": ["pid", "pid"], "order": ["p", "proba"]}


def test_rows_right_answer():
    out = {"pid": np.arange(6), "s": np.array([0, 0, 1, 1, 0, 7.0]),
           "valid": np.array([0, 0, 1, 1, 1, 0], bool)}
    res = query.check(ROWS, {"lo": 2, "hi": 5}, _ref(), out, TOL)
    assert res == {"rows": 3, "wrong": 0}


@pytest.mark.parametrize("edit, wrong", [
    (lambda o: o["valid"].__setitem__(1, True), 1),     # a row too many
    (lambda o: o["valid"].__setitem__(4, False), 1),    # a row missing
    (lambda o: o["s"].__setitem__(3, 0.0), 1),          # a label flipped
    (lambda o: o["pid"].__setitem__(2, 9), 1),          # a key wrong
])
def test_rows_each_fault_is_a_wrong_row(edit, wrong):
    out = {"pid": np.arange(6), "s": np.array([0, 0, 1, 1, 0, 0.0]),
           "valid": np.array([0, 0, 1, 1, 1, 0], bool)}
    edit(out)
    assert query.check(ROWS, {"lo": 2, "hi": 5}, _ref(), out,
                       TOL)["wrong"] == wrong


def test_rows_of_another_length_are_all_wrong():
    out = {"pid": np.arange(4), "s": np.zeros(4),
           "valid": np.ones(4, bool)}
    assert query.check(ROWS, {"lo": 0, "hi": 6}, _ref(), out, TOL) == \
        {"rows": 6, "wrong": 6}


def test_group_avg_by_hand():
    # x >= 2 keeps pids 0, 2, 3, 4: g=0 -> (.9 + .8 + .4) / 3, g=1 -> .6
    out = {"g": np.array([1, 0, 0]), "p": np.array([0.6, 0.7, 0.0]),
           "valid": np.array([1, 1, 0], bool)}
    res = query.check(GROUP, {"t": 2.0}, _ref(), out, TOL)
    assert res["rows"] == 2 and res["wrong"] == 0
    assert res["avg_gap"] == pytest.approx(0.0, abs=1e-12)
    out["p"][1] = 0.7 * (1 + 1e-3)
    assert query.check(GROUP, {"t": 2.0}, _ref(), out, TOL)["avg_gap"] == \
        pytest.approx(1e-3)
    out["g"][0] = 5                                    # a group renamed
    assert query.check(GROUP, {"t": 2.0}, _ref(), out, TOL)["wrong"] == 2


def test_top_k_by_hand_and_ties_in_any_order():
    ref = _ref()
    out = {"pid": np.array([0, 2]), "p": np.array([.9, .8]),
           "valid": np.array([1, 1], bool)}
    assert query.check(TOP, {"lo": 0, "hi": 6}, ref, out, TOL) == \
        {"rows": 2, "wrong": 0}
    ref["proba"][3] = 0.8                             # tie for second
    out["pid"][1] = 3
    assert query.check(TOP, {"lo": 0, "hi": 6}, ref, out, TOL)["wrong"] == 0


@pytest.mark.parametrize("pids, p, wrong", [
    ([2, 0], [.8, .9], 1),       # out of order
    ([0, 3], [.9, .6], 1),       # pid 3 is not in the top 2
    ([0, 0], [.9, .9], 1),       # a pid twice
    ([0, 5], [.9, .8], 1),       # pid 5 outside the cohort 0..4
    ([0], [.9], 1),              # one row short
])
def test_top_k_faults(pids, p, wrong):
    out = {"pid": np.array(pids), "p": np.array(p),
           "valid": np.ones(len(pids), bool)}
    got = query.check(TOP, {"lo": 0, "hi": 5}, _ref(), out, TOL)
    assert got["wrong"] >= wrong and got["wrong"] > 0


@pytest.mark.parametrize("expect, binding", [(ROWS, {"lo": 1, "hi": 5}),
                                             (GROUP, {"t": 1.0}),
                                             (TOP, {"lo": 1, "hi": 6})])
def test_the_reference_answer_passes_its_own_check(expect, binding):
    out = query.answer(expect, binding, _ref(), torch.float64)
    res = query.check(expect, binding, _ref(), out, TOL)
    assert res["wrong"] == 0 and res.get("avg_gap", 0.0) < 1e-15


def _stump_state(thr):
    """One tree of depth 1 on feature 0 (mean 1, std 2): left leaf p=1/4,
    right leaf p=3/4."""
    n = 3
    return {"featurizers": [{"kind": "scaler", "columns": ["a", "b"],
                             "mean": np.float32([1, 0]),
                             "std": np.float32([2, 1])}],
            "model": {"trees": [{
                "feature": np.int32([0, 0, 0]),
                "threshold": np.float32([thr, 0, 0]),
                "left": np.int32([1, -1, -1]), "right": np.int32([2, -1, -1]),
                "value": np.float32([[0, 0], [.75, .25], [.25, .75]]),
                "depth": 1, "n_features": 2}][:n]}}


def test_forest_reference_by_hand():
    mod = layout.module("reference", "random_forest")
    cols = {"a": np.float32([0, 1, 3, 5]), "b": np.zeros(4, np.float32)}
    # scaled a: -0.5, 0, 1, 2; threshold 0.5: left, left, right, right
    out = mod.outputs(_stump_state(0.5), cols, torch.float64,
                      torch.device("cpu"))
    assert out["predict"].tolist() == [0, 0, 1, 1]
    want = np.exp(.75) / (np.exp(.25) + np.exp(.75))
    assert out["proba"] == pytest.approx([1 - want, 1 - want, want, want])


def test_logistic_reference_by_hand():
    mod = layout.module("reference", "logistic_onehot")
    state = {"featurizers": [
        {"kind": "one_hot", "columns": ["c"],
         "categories": {"c": np.arange(3)}},
        {"kind": "scaler", "columns": ["d"], "mean": np.float32([10]),
         "std": np.float32([5])}],
        "model": {"weights": np.float32([0.5, 0, -1, 2]), "bias": -0.25}}
    cols = {"c": np.int32([0, 1, 2, 7]), "d": np.float32([10, 15, 5, 20])}
    logit = np.array([0.5 + 0 - .25, 0 + 2 - .25, -1 - 2 - .25,
                      0 + 4 - .25])
    out = mod.outputs(state, cols, torch.float64, torch.device("cpu"))
    assert out["proba"] == pytest.approx(1 / (1 + np.exp(-logit)))
    assert out["predict"].tolist() == [1, 1, 0, 1]


def test_forest_model_is_complete_and_every_node_is_reached():
    from raven_bench.counts import tree_sizes
    mod = layout.module("models", "random_forest")
    rng = np.random.default_rng(0)
    cols = {"a": rng.integers(0, 9, 5000).astype(np.int32),
            "g": rng.integers(0, 2, 5000).astype(np.int32),
            "b": rng.normal(size=5000).astype(np.float32)}
    spec = {"name": "m", "task": "classification", "features": ["a", "g", "b"],
            "n_trees": 4, "depth": 5, "leaf_grid": 256}
    state = mod.build(spec, cols, rng)
    sc = state["featurizers"][0]
    scaled = [(cols[c] - sc["mean"][j]) * (np.float32(1) / sc["std"][j])
              for j, c in enumerate(sc["columns"])]
    bounds = [(float(x.min()), float(x.max())) for x in scaled]
    x = np.stack(scaled, 1)
    for t in state["model"]["trees"]:
        assert tree_sizes.reachable(t, bounds) == (31, 32)
        # integer features split half-way between codes
        for f, th in zip(t["feature"][:31], t["threshold"][:31]):
            if f < 2:
                raw = th * sc["std"][f] + sc["mean"][f]
                assert abs(raw - np.floor(raw) - 0.5) < 1e-4
        # every leaf is reached by a row of the data
        node = np.zeros(len(x), np.int64)
        for _ in range(5):
            go = x[np.arange(len(x)), t["feature"][node]] <= \
                t["threshold"][node]
            node = np.where(go, t["left"][node], t["right"][node])
        assert len(np.unique(node)) >= 28          # nearly all 32 leaves
        leaves = t["value"][t["left"] < 0, 1]
        assert np.all(leaves * 256 == np.round(leaves * 256))
    assert mod.ops_per_row(state) == {"fp32": 20.0}


def test_logistic_model_support():
    mod = layout.module("models", "logistic_onehot")
    spec = {"name": "delay", "one_hot": {"origin": 322, "dest": 322,
                                         "carrier": 14, "dow": 7},
            "scaled": ["distance", "taxi_out", "dep_hour"],
            "support": {"origin": 40, "dest": 40, "carrier": 2},
            "support_scaled": ["taxi_out", "dep_hour"]}
    rng = np.random.default_rng(1)
    cols = {"distance": rng.uniform(100, 3000, 100).astype(np.float32),
            "taxi_out": rng.normal(15, 5, 100).astype(np.float32),
            "dep_hour": rng.integers(0, 24, 100).astype(np.int32)}
    state = mod.build(spec, cols, rng)
    w = state["model"]["weights"]
    assert len(w) == 668 and np.count_nonzero(w) == 84
    assert mod.input_columns(state) == ["origin", "dest", "carrier",
                                        "taxi_out", "dep_hour"]
