"""Raven Fig 2a's pipeline, made from the seed: one-hot encoding of the
categorical columns (every code of the column's domain is a feature), a
standard scaler on the numeric columns, then a logistic regression.

The coefficients are nonzero only on the support of the process that
generates the flights table (the chronically delayed airports as origin
and as destination, the delayed carriers, the departure hour and the
taxi-out time), as an L1 fit that recovers the support gives, and exact
zeros elsewhere, so projection pushdown has features to drop.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def build(spec: Dict, columns: Dict[str, np.ndarray],
          rng: np.random.Generator) -> Dict:
    one_hot = dict(spec["one_hot"])            # column -> domain size
    scaled = list(spec["scaled"])
    support = dict(spec["support"])            # column -> leading codes
    categories = {c: np.arange(n, dtype=np.int32) for c, n in one_hot.items()}
    weights = []
    for c, n in one_hot.items():
        w = np.zeros(n, np.float32)
        s = int(support.get(c, 0))
        w[:s] = rng.normal(1.0, 0.5, s).astype(np.float32)
        weights.append(w)
    mat = np.stack([np.asarray(columns[c], np.float64) for c in scaled], 1)
    mean = mat.mean(0).astype(np.float32)
    std = (mat.std(0) + 1e-8).astype(np.float32)
    w_num = np.zeros(len(scaled), np.float32)
    for i, c in enumerate(scaled):
        if c in spec["support_scaled"]:
            w_num[i] = np.float32(rng.normal(0.0, 0.5))
    weights.append(w_num)
    meta = {"name": spec["name"], "flavor": "python",
            "python_version": "3", "dependencies": [],
            "signature_inputs": list(one_hot) + scaled,
            "task": "classification"}
    return {"featurizers": [
                {"kind": "one_hot", "columns": list(one_hot),
                 "categories": categories},
                {"kind": "scaler", "columns": scaled, "mean": mean,
                 "std": std}],
            "model": {"kind": "logistic_regression", "l1": 0.0, "lr": 0.1,
                      "steps": 0, "seed": 0,
                      "weights": np.concatenate(weights),
                      "bias": float(np.float32(rng.normal(-2.0, 0.25))),
                      "feature_names": None},
            "metadata": meta}


def _blocks(state: Dict):
    """(column, weights of its features) for every input column."""
    w = np.asarray(state["model"]["weights"])
    off = 0
    for f in state["featurizers"]:
        if f["kind"] == "one_hot":
            for c in f["columns"]:
                n = len(f["categories"][c])
                yield c, w[off:off + n]
                off += n
        else:
            for c in f["columns"]:
                yield c, w[off:off + 1]
                off += 1


def input_columns(state: Dict) -> list:
    """Columns the model needs: those with a nonzero weight."""
    return [c for c, w in _blocks(state) if np.any(w != 0)]


def ops_per_row(state: Dict) -> Dict[str, float]:
    """A multiply and an add for each nonzero weight."""
    return {"fp32": 2.0 * float(np.count_nonzero(
        np.asarray(state["model"]["weights"])))}
