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

__all__ = ["LinearRegression", "LogisticRegression", "rowwise_matmul",
           "rowwise_sigmoid"]


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` ([n, k] by [k] or [k, m]) with each output row computed
    from its own input row alone, in one fixed order: a left fold of
    elementwise products over ``k``.  A BLAS GEMV or GEMM picks its kernel
    and blocking by shape, so the bits of a row would depend on how many
    rows share the call and where the row sits among them; the fold gives
    the same bits whatever the row count — chunked, stacked, padded or
    sharded row-local execution stays bitwise equal to whole-table."""
    w2 = w[:, None] if w.ndim == 1 else w
    if w2.shape[0] == 0:
        acc = x.new_zeros((x.shape[0], w2.shape[1]))
    else:
        acc = x[:, 0:1] * w2[0]
        for i in range(1, w2.shape[0]):
            acc = acc + x[:, i:i + 1] * w2[i]
    return acc[:, 0] if w.ndim == 1 else acc


def rowwise_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid evaluated in float64 and rounded to ``x``'s dtype.  Torch's
    float32 CPU kernel runs whole vectors through one formula and a
    leftover tail (of the tensor, or of each thread's range) through a
    scalar one that rounds differently, so an element's bits would depend
    on the batch it came in; in float64 both agree far below a float32
    ulp, and the rounded result is the same whatever the batch."""
    return torch.sigmoid(x.to(torch.float64)).to(x.dtype)


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
        """``x @ w + bias`` (row by row, :func:`rowwise_matmul`) with the
        weights placed on ``device``."""
        w = torch.as_tensor(np.asarray(self.weights, np.float32),
                            device=device)
        bias = self.bias
        return lambda x: rowwise_matmul(x.to(torch.float32), w) + bias

    def decision_function(self, x: torch.Tensor) -> torch.Tensor:
        return self.scorer(x.device)(x)


class LinearRegression(_LinearBase):
    kind = "linear_regression"

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.decision_function(x)


class LogisticRegression(_LinearBase):
    kind = "logistic_regression"

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return rowwise_sigmoid(self.decision_function(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.decision_function(x) > 0).to(torch.int32)
