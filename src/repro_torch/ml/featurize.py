"""Data featurizers (MLD operators): one-hot, scaler, imputer, bucketizer.

Featurizers are first-class Raven IR operators: the static analyzer maps
sklearn-style preprocessing onto these, the optimizer reasons about them
(predicate-based pruning constant-folds one-hot groups; NN translation turns
them into LA ops), and codegen executes them inside the compiled plan.

Each featurizer knows (a) how to fit on host data (numpy, as in the JAX
package), (b) how to apply on tensors — ``bind(device)`` places its fitted
constants on the device once and returns the transform, which is what a
compiled plan holds; ``transform`` binds on every call — and (c) its
feature mapping: input column -> output feature slice (needed by
projection pushdown to trace zero weights back to source columns).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["OneHotEncoder", "StandardScaler", "Imputer", "Bucketizer",
           "FeatureMapping", "Transform"]

Transform = Callable[[Mapping[str, torch.Tensor]], torch.Tensor]


def _device_of(columns: Mapping[str, torch.Tensor]) -> torch.device:
    return next(iter(columns.values())).device


def _stack_f32(columns: Mapping[str, torch.Tensor],
               names: Sequence[str]) -> torch.Tensor:
    return torch.stack([columns[c].to(torch.float32) for c in names], dim=1)


@dataclasses.dataclass
class FeatureMapping:
    """Output feature i comes from input column ``source[i]``; for one-hot
    features ``category[i]`` holds the matching category code, else -1."""

    names: List[str]
    source: List[str]
    category: List[int]

    @property
    def n_features(self) -> int:
        return len(self.names)


class OneHotEncoder:
    kind = "one_hot"

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.categories: Dict[str, np.ndarray] = {}

    def fit(self, data: Dict[str, np.ndarray]) -> "OneHotEncoder":
        for c in self.columns:
            self.categories[c] = np.unique(np.asarray(data[c]))
        return self

    def mapping(self) -> FeatureMapping:
        names, source, cat = [], [], []
        for c in self.columns:
            for v in self.categories[c]:
                names.append(f"{c}={v}")
                source.append(c)
                cat.append(int(v))
        return FeatureMapping(names, source, cat)

    def bind(self, device) -> Transform:
        cats = [(c, torch.as_tensor(self.categories[c], device=device))
                for c in self.columns]

        def transform(columns):
            return torch.cat([(columns[c][:, None] == k[None, :])
                              .to(torch.float32) for c, k in cats], dim=1)
        return transform

    def transform(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.bind(_device_of(columns))(columns)

    def restrict(self, keep: Sequence[int]) -> Optional["OneHotEncoder"]:
        """Keep only the given local output-feature indices (projection
        pushdown).  Returns None if nothing survives."""
        keep = set(keep)
        new_cols: List[str] = []
        new_cats: Dict[str, np.ndarray] = {}
        offset = 0
        for c in self.columns:
            cats = self.categories[c]
            kept = [v for i, v in enumerate(cats) if offset + i in keep]
            offset += len(cats)
            if kept:
                new_cols.append(c)
                new_cats[c] = np.asarray(kept)
        if not new_cols:
            return None
        enc = OneHotEncoder(new_cols)
        enc.categories = new_cats
        return enc


class StandardScaler:
    kind = "scaler"

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data: Dict[str, np.ndarray]) -> "StandardScaler":
        mat = np.stack([np.asarray(data[c], np.float64) for c in self.columns],
                       axis=1)
        self.mean = mat.mean(0).astype(np.float32)
        self.std = (mat.std(0) + 1e-8).astype(np.float32)
        return self

    def mapping(self) -> FeatureMapping:
        return FeatureMapping(list(self.columns), list(self.columns),
                              [-1] * len(self.columns))

    def bind(self, device) -> Transform:
        # Multiply by the float32 reciprocal: the JAX package runs this
        # jitted, and XLA rewrites a division by a constant into exactly
        # that, so the features (and every tree decision on them) match.
        mean = torch.as_tensor(self.mean, device=device)
        inv_std = torch.as_tensor(np.float32(1.0) / self.std, device=device)
        names = list(self.columns)

        def transform(columns):
            return (_stack_f32(columns, names) - mean) * inv_std
        return transform

    def transform(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.bind(_device_of(columns))(columns)

    # LA form (for NN translation): x*a + b
    def affine(self) -> Tuple[np.ndarray, np.ndarray]:
        return (1.0 / self.std).astype(np.float32), \
            (-self.mean / self.std).astype(np.float32)

    def restrict(self, keep: Sequence[int]) -> Optional["StandardScaler"]:
        keep = sorted(set(keep))
        if not keep:
            return None
        sc = StandardScaler([self.columns[i] for i in keep])
        sc.mean = self.mean[keep]
        sc.std = self.std[keep]
        return sc


class Imputer:
    kind = "imputer"

    def __init__(self, columns: Sequence[str], strategy: str = "mean"):
        self.columns = list(columns)
        self.strategy = strategy
        self.fill: Optional[np.ndarray] = None

    def fit(self, data: Dict[str, np.ndarray]) -> "Imputer":
        fills = []
        for c in self.columns:
            arr = np.asarray(data[c], np.float64)
            ok = arr[~np.isnan(arr)]
            fills.append(np.mean(ok) if self.strategy == "mean"
                         else np.median(ok))
        self.fill = np.asarray(fills, np.float32)
        return self

    def mapping(self) -> FeatureMapping:
        return FeatureMapping(list(self.columns), list(self.columns),
                              [-1] * len(self.columns))

    def bind(self, device) -> Transform:
        fill = torch.as_tensor(self.fill, device=device)
        names = list(self.columns)

        def transform(columns):
            mat = _stack_f32(columns, names)
            return torch.where(torch.isnan(mat), fill, mat)
        return transform

    def transform(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.bind(_device_of(columns))(columns)

    def restrict(self, keep: Sequence[int]) -> Optional["Imputer"]:
        keep = sorted(set(keep))
        if not keep:
            return None
        im = Imputer([self.columns[i] for i in keep], self.strategy)
        im.fill = self.fill[keep]
        return im


class Bucketizer:
    kind = "bucketizer"

    def __init__(self, column: str, boundaries: Sequence[float]):
        self.column = column
        self.boundaries = np.asarray(sorted(boundaries), np.float32)

    def fit(self, data) -> "Bucketizer":
        return self

    def mapping(self) -> FeatureMapping:
        ids = (self._kept if self._kept is not None
               else np.arange(len(self.boundaries) + 1))
        return FeatureMapping([f"{self.column}_bucket{int(i)}" for i in ids],
                              [self.column] * len(ids),
                              [int(i) for i in ids])

    def bind(self, device) -> Transform:
        boundaries = torch.as_tensor(self.boundaries, device=device)
        ids = torch.as_tensor(
            (self._kept if self._kept is not None
             else np.arange(len(self.boundaries) + 1)).astype(np.int32),
            device=device)
        column = self.column

        def transform(columns):
            x = columns[column].to(torch.float32)
            bucket = torch.searchsorted(boundaries, x, out_int32=True)
            return (bucket[:, None] == ids[None, :]).to(torch.float32)
        return transform

    def transform(self, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.bind(_device_of(columns))(columns)

    _kept: Optional[np.ndarray] = None

    def restrict(self, keep: Sequence[int]) -> Optional["Bucketizer"]:
        keep = sorted(set(keep))
        if not keep:
            return None
        base = self._kept if self._kept is not None \
            else np.arange(len(self.boundaries) + 1)
        b = Bucketizer(self.column, self.boundaries.tolist())
        b._kept = np.asarray([base[i] for i in keep])
        return b
