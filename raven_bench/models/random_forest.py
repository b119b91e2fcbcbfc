"""A random forest of complete trees over scaled features, made from the
seed in the layout a fitted model is carried in (``pipeline_from_state``).

Each tree is complete: 2**depth - 1 internal nodes in heap order (node i's
children are 2i+1 and 2i+2) and 2**depth leaves, and, as in a fitted tree,
every node is reached by some rows of the data: a node splits a feature
that still has data values on both sides within the ranges its ancestors
left, drawn uniformly among such features, at a quantile of that feature
drawn uniformly over the inner four fifths of what is left of its range.
An integer-valued feature splits half-way between two codes.  Thresholds
are then scaled like the feature.  A leaf holds class probabilities [1 - p,
p] with p = k / ``leaf_grid``: multiples of a power of two, so every sum of
leaves over the forest is exact in float32, in any order of summation.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

LEVELS = np.linspace(0.0, 1.0, 1025)


def _split(rng, kinds, table, bounds):
    """(feature, raw threshold, left bounds, right bounds) of one node.  A
    continuous feature's bounds are quantile levels, an integer feature's
    its lowest and highest code."""
    open_ = [f for f, (lo, hi) in enumerate(bounds)
             if (hi > lo if kinds[f] else hi - lo > 1e-3)]
    f = open_[int(rng.integers(len(open_)))]
    lo, hi = bounds[f]
    left, right = list(bounds), list(bounds)
    if kinds[f]:
        a = np.interp(lo, table[:, f], LEVELS)
        b = np.interp(hi, table[:, f], LEVELS)
        u = rng.uniform(a + 0.1 * (b - a), b - 0.1 * (b - a))
        raw = np.interp(u, LEVELS, table[:, f])
        k = int(min(max(np.floor(raw), lo), hi - 1))
        left[f], right[f] = (lo, k), (k + 1, hi)
        return f, k + 0.5, left, right
    u = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo))
    left[f], right[f] = (lo, u), (u, hi)
    return f, float(np.interp(u, LEVELS, table[:, f])), left, right


def build(spec: Dict, columns: Dict[str, np.ndarray],
          rng: np.random.Generator) -> Dict:
    feats = list(spec["features"])
    mat = np.stack([np.asarray(columns[c], np.float64) for c in feats], 1)
    mean = mat.mean(0).astype(np.float32)
    std = (mat.std(0) + 1e-8).astype(np.float32)
    table = np.quantile(mat, LEVELS, axis=0)             # [1025, F]
    kinds = [np.issubdtype(np.asarray(columns[c]).dtype, np.integer)
             for c in feats]
    root = [(float(table[0, f]), float(table[-1, f])) if kinds[f]
            else (0.0, 1.0) for f in range(len(feats))]
    t, depth = int(spec["n_trees"]), int(spec["depth"])
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    n_nodes = n_int + n_leaf
    trees: List[Dict] = []
    for _ in range(t):
        feature = np.zeros(n_nodes, np.int32)
        raw = np.zeros(n_nodes)
        bounds = {0: root}
        for i in range(n_int):
            f, thr, lb, rb = _split(rng, kinds, table, bounds.pop(i))
            feature[i], raw[i] = f, thr
            bounds[2 * i + 1], bounds[2 * i + 2] = lb, rb
        threshold = np.zeros(n_nodes, np.float32)
        threshold[:n_int] = ((raw[:n_int] - mean[feature[:n_int]])
                             / std[feature[:n_int]]).astype(np.float32)
        left = np.full(n_nodes, -1, np.int32)
        right = np.full(n_nodes, -1, np.int32)
        left[:n_int] = 2 * np.arange(n_int) + 1
        right[:n_int] = 2 * np.arange(n_int) + 2
        p = (rng.integers(0, int(spec["leaf_grid"]) + 1, n_leaf)
             / float(spec["leaf_grid"])).astype(np.float32)
        value = np.zeros((n_nodes, 2), np.float32)
        value[n_int:, 0] = np.float32(1.0) - p
        value[n_int:, 1] = p
        trees.append({"feature": feature, "threshold": threshold,
                      "left": left, "right": right, "value": value,
                      "depth": depth, "n_features": len(feats)})
    meta = {"name": spec["name"], "flavor": "python",
            "python_version": "3", "dependencies": [],
            "signature_inputs": feats, "task": spec["task"]}
    return {"featurizers": [{"kind": "scaler", "columns": feats,
                             "mean": mean, "std": std}],
            "model": {"kind": "random_forest", "n_trees": t,
                      "task": spec["task"], "max_depth": depth,
                      "min_leaf": 1, "seed": 0, "trees": trees,
                      "feature_names": feats},
            "metadata": meta}


def input_columns(state: Dict) -> list:
    """Columns the model reads."""
    return list(state["featurizers"][0]["columns"])


def ops_per_row(state: Dict) -> Dict[str, float]:
    """The least operations a row needs: one comparison a level of every
    tree (the forest's own depths, no padding)."""
    return {"fp32": float(sum(t["depth"]
                              for t in state["model"]["trees"]))}
