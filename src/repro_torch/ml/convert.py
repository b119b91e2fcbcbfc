"""Carry fitted pipelines across as plain numpy state.

``pipeline_state`` reads a fitted pipeline — this package's, or any object
with the same attribute layout, such as the JAX package's — into a dict of
python scalars, lists and numpy arrays; ``pipeline_from_state`` builds this
package's :class:`~repro_torch.ml.pipeline.Pipeline` from such a dict.  The
state holds the featurizers' fitted statistics, each tree's ``TreeArrays``
fields, linear weights and bias, and MLP ``[{"w", "b"}]`` layers.  Arrays are
read with ``np.asarray``, so any array type that converts to numpy works.

The port needs no other package to get a fitted model: it fits its own
linear, logistic and MLP models on ``torch.autograd`` (``fit(...,
device=...)``, ``Pipeline.fit``) and its trees in numpy, and clusters them
(``repro_torch.core.clustering``).  Carrying state across is for holding
the two packages to each other on the same fitted model, and for moving a
model fitted on one device to a store on another.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .featurize import Bucketizer, Imputer, OneHotEncoder, StandardScaler
from .linear import LinearRegression, LogisticRegression
from .mlp import MLP
from .pipeline import Pipeline, PipelineMetadata
from .tree import DecisionTree, GradientBoostedTrees, RandomForest, TreeArrays

__all__ = ["pipeline_state", "pipeline_from_state", "model_state",
           "model_from_state"]

_TREE_FIELDS = ("feature", "threshold", "left", "right", "value")
_META_FIELDS = ("name", "flavor", "python_version", "dependencies",
                "signature_inputs", "task")


def _tree_state(tree: Any) -> Dict[str, Any]:
    out = {f: np.array(getattr(tree, f)) for f in _TREE_FIELDS}
    out["depth"] = int(tree.depth)
    out["n_features"] = int(tree.n_features)
    return out


def _tree_from_state(s: Dict[str, Any]) -> TreeArrays:
    return TreeArrays(
        feature=np.asarray(s["feature"], np.int32),
        threshold=np.asarray(s["threshold"], np.float32),
        left=np.asarray(s["left"], np.int32),
        right=np.asarray(s["right"], np.int32),
        value=np.asarray(s["value"], np.float32),
        depth=int(s["depth"]), n_features=int(s["n_features"]))


def _featurizer_state(f: Any) -> Dict[str, Any]:
    if f.kind == "scaler":
        return {"kind": f.kind, "columns": list(f.columns),
                "mean": np.array(f.mean), "std": np.array(f.std)}
    if f.kind == "one_hot":
        return {"kind": f.kind, "columns": list(f.columns),
                "categories": {c: np.array(v)
                               for c, v in f.categories.items()}}
    if f.kind == "imputer":
        return {"kind": f.kind, "columns": list(f.columns),
                "strategy": f.strategy, "fill": np.array(f.fill)}
    if f.kind == "bucketizer":
        kept = getattr(f, "_kept", None)
        return {"kind": f.kind, "column": f.column,
                "boundaries": np.array(f.boundaries),
                "kept": None if kept is None else np.array(kept)}
    raise ValueError(f"unknown featurizer kind {f.kind!r}")


def _featurizer_from_state(s: Dict[str, Any]):
    kind = s["kind"]
    if kind == "scaler":
        f = StandardScaler(s["columns"])
        f.mean = np.asarray(s["mean"], np.float32)
        f.std = np.asarray(s["std"], np.float32)
        return f
    if kind == "one_hot":
        f = OneHotEncoder(s["columns"])
        f.categories = {c: np.asarray(v) for c, v in s["categories"].items()}
        return f
    if kind == "imputer":
        f = Imputer(s["columns"], s["strategy"])
        f.fill = np.asarray(s["fill"], np.float32)
        return f
    if kind == "bucketizer":
        f = Bucketizer(s["column"], np.asarray(s["boundaries"]).tolist())
        if s["kept"] is not None:
            f._kept = np.asarray(s["kept"])
        return f
    raise ValueError(f"unknown featurizer kind {kind!r}")


def model_state(m: Any) -> Dict[str, Any]:
    """Plain-numpy state of a fitted model (any supported kind)."""
    kind = m.kind
    names = list(m.feature_names) if m.feature_names else None
    if kind == "decision_tree":
        return {"kind": kind, "task": m.task, "max_depth": m.max_depth,
                "min_leaf": m.min_leaf, "tree": _tree_state(m.tree),
                "feature_names": names}
    if kind == "random_forest":
        return {"kind": kind, "n_trees": m.n_trees, "task": m.task,
                "max_depth": m.max_depth, "min_leaf": m.min_leaf,
                "seed": m.seed, "trees": [_tree_state(t) for t in m.trees],
                "feature_names": names}
    if kind == "gbt":
        return {"kind": kind, "n_trees": m.n_trees, "max_depth": m.max_depth,
                "learning_rate": m.learning_rate, "min_leaf": m.min_leaf,
                "base": float(m.base),
                "trees": [_tree_state(t) for t in m.trees],
                "feature_names": names}
    if kind in ("linear_regression", "logistic_regression"):
        return {"kind": kind, "l1": m.l1, "lr": m.lr, "steps": m.steps,
                "seed": m.seed, "weights": np.array(m.weights),
                "bias": float(m.bias), "feature_names": names}
    if kind == "mlp":
        return {"kind": kind, "hidden": list(m.hidden),
                "n_outputs": m.n_outputs, "task": m.task, "lr": m.lr,
                "steps": m.steps, "seed": m.seed,
                "params": [{"w": np.array(p["w"]), "b": np.array(p["b"])}
                           for p in m.params],
                "feature_names": names}
    raise ValueError(f"unknown model kind {kind!r}")


def model_from_state(s: Dict[str, Any]):
    """This package's model, built from :func:`model_state` output."""
    kind = s["kind"]
    if kind == "decision_tree":
        m = DecisionTree(s["task"], s["max_depth"], s["min_leaf"])
        m.tree = _tree_from_state(s["tree"])
    elif kind == "random_forest":
        m = RandomForest(s["n_trees"], s["task"], s["max_depth"],
                         s["min_leaf"], s["seed"])
        m.trees = [_tree_from_state(t) for t in s["trees"]]
    elif kind == "gbt":
        m = GradientBoostedTrees(s["n_trees"], s["max_depth"],
                                 s["learning_rate"], s["min_leaf"])
        m.base = float(s["base"])
        m.trees = [_tree_from_state(t) for t in s["trees"]]
    elif kind in ("linear_regression", "logistic_regression"):
        cls = LinearRegression if kind == "linear_regression" \
            else LogisticRegression
        m = cls(s["l1"], s["lr"], s["steps"], s["seed"])
        m.weights = np.asarray(s["weights"], np.float32)
        m.bias = float(s["bias"])
    elif kind == "mlp":
        m = MLP(s["hidden"], s["n_outputs"], s["task"], s["lr"], s["steps"],
                s["seed"])
        m.params = [{"w": np.asarray(p["w"], np.float32),
                     "b": np.asarray(p["b"], np.float32)}
                    for p in s["params"]]
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    m.feature_names = s["feature_names"]
    return m


def pipeline_state(pipe: Any) -> Dict[str, Any]:
    """Plain-numpy state of a fitted pipeline (see module note)."""
    meta = {f: getattr(pipe.metadata, f) for f in _META_FIELDS}
    return {"featurizers": [_featurizer_state(f) for f in pipe.featurizers],
            "model": model_state(pipe.model), "metadata": meta}


def pipeline_from_state(state: Dict[str, Any]) -> Pipeline:
    """This package's pipeline, built from :func:`pipeline_state` output."""
    return Pipeline([_featurizer_from_state(f) for f in state["featurizers"]],
                    model_from_state(state["model"]),
                    PipelineMetadata(**state["metadata"]))
