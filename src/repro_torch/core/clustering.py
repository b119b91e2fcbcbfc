"""Model clustering (paper §4.1, Fig 2b).

Offline: k-means over (a sample of) historical data; for each cluster, derive
the value-ranges its members occupy and *precompile* a specialized model —
pruned trees / restricted linear models — exactly like predicate-based pruning
but driven by discovered data properties instead of WHERE clauses.

Online: route each batch to its cluster's precompiled model; fall back to the
original when no precompiled model matches (paper: "if a precompiled model
does not exist, we fall back").  ``ClusteredModel.predict_routed`` implements
the routed execution used by the benchmark, grouping rows on the columns'
device; artifacts are stored in the model store via ``register_clustered``.
k-means runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ml.pipeline import Pipeline
from ..relational.expr import Constraint
from ..relational.table import resolve_device
from .rules.common import (constant_features, feature_bounds,
                           input_columns_of, restrict_featurizers)
from .rules.predicate_pruning import _fold_linear_constants
from .rules.projection_pushdown import _restrict_model

__all__ = ["kmeans", "build_clustered_model", "ClusteredModel"]


def _nearest(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Index of each row's nearest centroid (the first one on a tie, as
    ``jnp.argmin`` and ``torch.argmin`` both take it)."""
    d = torch.sum((x[:, None, :] - cents[None, :, :]) ** 2, dim=-1)
    return torch.argmin(d, dim=1)


def kmeans(x: Any, k: int, iters: int = 20, seed: int = 0, *,
           init_idx: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain Lloyd's on ``x``'s device (an array that is not a tensor goes
    to the card).  Returns (float32 centroids [k, d], int64 assignment
    [n]).  The initial centroids are the rows ``init_idx``, by default the
    first ``k`` of ``torch.randperm(n)`` from a CPU generator seeded with
    ``seed``, so the card and the CPU start from the same rows."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32),
                            device=resolve_device(None))
    x = x.to(torch.float32)
    if init_idx is None:
        init_idx = torch.randperm(
            x.shape[0], generator=torch.Generator().manual_seed(seed))[:k]
    cents = x[torch.as_tensor(np.array(init_idx), dtype=torch.int64,
                              device=x.device)]
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(_nearest(x, cents), k).to(
            torch.float32)
        counts = onehot.sum(0)[:, None]
        sums = onehot.T @ x
        cents = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                            cents)
    return cents, _nearest(x, cents)


def _cluster_constraints(sample_cols: Dict[str, np.ndarray],
                         assign: np.ndarray, cid: int) -> List[Constraint]:
    """Per-column [min,max] (plus == for single-valued) inside one cluster."""
    out: List[Constraint] = []
    mask = assign == cid
    for name, arr in sample_cols.items():
        vals = np.asarray(arr, np.float64)[mask]
        if vals.size == 0:
            continue
        uniq = np.unique(vals)
        if uniq.size == 1:
            out.append(Constraint(name, "==", float(uniq[0])))
        else:
            out.append(Constraint(name, ">=", float(vals.min())))
            out.append(Constraint(name, "<=", float(vals.max())))
    return out


@dataclasses.dataclass
class _ClusterEntry:
    centroid: np.ndarray
    featurizers: List[Any]
    model: Any
    n_features: int


class ClusteredModel:
    """Precompiled per-cluster specializations + fallback.  Its state is
    host numpy (centroids, featurizer statistics, weights), so one object
    serves columns on any device."""

    def __init__(self, pipeline: Pipeline, centroids: np.ndarray,
                 entries: List[_ClusterEntry],
                 cluster_columns: List[str]):
        self.pipeline = pipeline
        self.centroids = centroids
        self.entries = entries
        self.cluster_columns = cluster_columns

    def assign(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Each row's cluster (int64, on the columns' device)."""
        x = torch.stack([columns[c].to(torch.float32)
                         for c in self.cluster_columns], dim=1)
        return _nearest(x, torch.as_tensor(self.centroids, device=x.device))

    def model_cost(self) -> Dict[str, float]:
        """Feature-count cost of specialized models vs the original (the
        paper's 'model compile time is negligible; inference gains come from
        dropped features')."""
        orig = self.pipeline.feature_mapping().n_features
        spec = float(np.mean([e.n_features for e in self.entries]))
        return {"original_features": orig, "mean_cluster_features": spec}

    def predict_routed(self, columns: Dict[str, torch.Tensor],
                       assign: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Route rows to their cluster's precompiled model, grouped on the
        columns' device (each cluster's rows gathered, featurized, predicted
        and scattered back); returns float32 predictions on that device,
        aligned to input order."""
        if assign is None:
            assign = self.assign(columns)
        first = next(iter(columns.values()))
        out = torch.zeros(first.shape[0], dtype=torch.float32,
                          device=first.device)
        for cid, entry in enumerate(self.entries):
            idx = torch.nonzero(assign == cid).flatten()
            if idx.numel() == 0:
                continue
            sub = {c: columns[c].index_select(0, idx)
                   for c in input_columns_of(entry.featurizers)}
            x = torch.cat([f.transform(sub) for f in entry.featurizers],
                          dim=1)
            out[idx] = entry.model.predict(x).to(torch.float32)
        return out


def build_clustered_model(pipeline: Pipeline,
                          sample_cols: Dict[str, np.ndarray],
                          k: int, seed: int = 0,
                          cluster_columns: Optional[Sequence[str]] = None,
                          *, init_idx: Any = None, device: Any = None
                          ) -> ClusteredModel:
    """Offline precompilation: cluster the (host) sample with k-means on
    ``device`` (``None`` is the card), then specialize per cluster."""
    cluster_columns = list(cluster_columns or pipeline.input_columns())
    x = np.stack([np.asarray(sample_cols[c], np.float32)
                  for c in cluster_columns], axis=1)
    cents, assign = kmeans(torch.as_tensor(x, device=resolve_device(device)),
                           k, seed=seed, init_idx=init_idx)
    cents, assign = cents.cpu().numpy(), assign.cpu().numpy()
    entries: List[_ClusterEntry] = []
    for cid in range(k):
        constraints = _cluster_constraints(
            {c: sample_cols[c] for c in cluster_columns}, assign, cid)
        bounds = feature_bounds(pipeline.featurizers, constraints)
        model = pipeline.model
        feats = pipeline.featurizers
        kind = getattr(model, "kind", None)
        if kind in ("decision_tree",):
            pruned = model.tree.prune_with_constraints(bounds)
            model = copy.copy(model)
            model.tree = pruned
            # drop features the pruned tree no longer uses
            used = set(int(i) for i in pruned.used_features())
            feats, index_map = restrict_featurizers(pipeline.featurizers, used)
            kept_old = sorted(index_map, key=lambda o: index_map[o])
            model = _restrict_model(model, kept_old) or model
            nf = len(kept_old)
        elif kind in ("linear_regression", "logistic_regression"):
            consts = constant_features(bounds)
            res = _fold_linear_constants(model, consts, pipeline.featurizers)
            if res is not None:
                model, feats, _ = res
            nf = int(np.asarray(model.weights).shape[0])
        else:
            nf = pipeline.feature_mapping().n_features
        entries.append(_ClusterEntry(cents[cid], list(feats), model, nf))
    return ClusteredModel(pipeline, cents, entries, cluster_columns)
