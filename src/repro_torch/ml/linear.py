"""Linear / logistic regression: inference on tensors.

The paper's model-projection-pushdown experiments (Fig 2a) rely on
L1-regularized logistic regression whose zero weights let features be
projected out early; ``zero_weight_features()`` exposes them to the
optimizer rule.  The JAX package trains with proximal gradient descent
(``jax.grad``); that fit is not ported yet, so the port builds these models
from fitted weights (``repro_torch.ml.convert``) and only infers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["LinearRegression", "LogisticRegression"]


class _LinearBase:
    def __init__(self, l1: float = 0.0, lr: float = 0.1, steps: int = 400,
                 seed: int = 0):
        self.l1 = l1
        self.lr = lr
        self.steps = steps
        self.seed = seed
        self.weights: Optional[np.ndarray] = None   # [d]
        self.bias: float = 0.0
        self.feature_names: Optional[List[str]] = None

    def fit(self, x: np.ndarray, y: np.ndarray,
            feature_names: Optional[Sequence[str]] = None):
        raise NotImplementedError(
            f"{type(self).__name__}.fit is not ported yet; build the model "
            f"from fitted weights with repro_torch.ml.convert")

    def zero_weight_features(self, tol: float = 1e-8) -> np.ndarray:
        return np.nonzero(np.abs(self.weights) <= tol)[0]

    def nonzero_weight_features(self, tol: float = 1e-8) -> np.ndarray:
        return np.nonzero(np.abs(self.weights) > tol)[0]

    def sparsity(self) -> float:
        return float((np.abs(self.weights) <= 1e-8).mean())

    def restrict_features(self, keep: np.ndarray):
        """Return a copy using only ``keep`` features (projection pushdown)."""
        clone = self.__class__(self.l1, self.lr, self.steps, self.seed)
        clone.weights = self.weights[keep]
        clone.bias = self.bias
        if self.feature_names:
            clone.feature_names = [self.feature_names[i] for i in keep]
        return clone

    def scorer(self, device):
        """``x @ w + bias`` with the weights placed on ``device``."""
        w = torch.as_tensor(np.asarray(self.weights, np.float32),
                            device=device)
        bias = self.bias
        return lambda x: x.to(torch.float32) @ w + bias

    def decision_function(self, x: torch.Tensor) -> torch.Tensor:
        return self.scorer(x.device)(x)


class LinearRegression(_LinearBase):
    kind = "linear_regression"

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.decision_function(x)


class LogisticRegression(_LinearBase):
    kind = "logistic_regression"

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.decision_function(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.decision_function(x) > 0).to(torch.int32)
