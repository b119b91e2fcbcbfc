"""Linear / logistic regression with L1 (proximal) training, on tensors.

The paper's model-projection-pushdown experiments (Fig 2a) rely on
L1-regularized logistic regression whose zero weights let features be
projected out early.  ``fit`` trains with proximal gradient descent (ISTA)
on ``torch.autograd``, on the card unless ``device=`` asks for the CPU, so
the solution is *exactly* sparse; ``zero_weight_features()`` exposes the
zeros to the optimizer rule.  Inference is row-local
(:func:`rowwise_matmul`, :func:`rowwise_sigmoid`).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..relational.table import resolve_device

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


def fit_tensors(x: Any, y: Any, device: Any, y_dtype: torch.dtype
                ) -> tuple:
    """``x`` (float32) and ``y`` on the device a fit runs on: a tensor
    ``x`` keeps its own device unless ``device`` names one; anything else
    goes to :func:`resolve_device` (``None`` is the card, with no quiet
    CPU fallback)."""
    if device is None and isinstance(x, torch.Tensor):
        dev = x.device
    else:
        dev = resolve_device(device)
    return (torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=y_dtype, device=dev))


def _abs(z: torch.Tensor) -> torch.Tensor:
    """``|z|`` whose derivative at 0 is 1, as ``jax.grad(jnp.abs)`` has it;
    torch's ``abs`` backward gives 0 there.  Every logit is 0 at the first
    ISTA step (w = 0, b = 0), so the choice moves the bias by ``lr / 2``
    in that step and the whole fit after it."""
    return torch.where(z >= 0, z, -z)


def _soft_threshold(w: torch.Tensor, lam: float) -> torch.Tensor:
    return torch.sign(w) * torch.clamp(torch.abs(w) - lam, min=0.0)


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

    def fit(self, x: Any, y: Any,
            feature_names: Optional[Sequence[str]] = None, *,
            device: Any = None):
        """ISTA on the standardized features (population std + 1e-6), the
        scales folded back into the weights and the bias after, on
        ``device`` (see :func:`fit_tensors`).  Data, weights and updates
        are float32; the objective and its sums over the rows run in
        float64, so the gradient is the float32 rounding of its exact
        value whatever the device (float32 BLAS over 700,000 rows left
        the weights ~7e-5 off a float64 fit on the CPU, and the card's
        reductions round otherwise).  The weights come back as numpy
        float32."""
        x, y = fit_tensors(x, y, device, torch.float32)
        # Standardize for conditioning; fold scales back into weights after.
        mu = x.mean(0)
        sd = x.std(0, correction=0) + 1e-6      # jnp.std: the population std
        xs = ((x - mu) / sd).to(torch.float64)
        y = y.to(torch.float64)
        w = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        b = torch.zeros((), dtype=torch.float32, device=x.device)
        lam = self.l1 * self.lr
        for _ in range(self.steps):
            w.requires_grad_(True)
            b.requires_grad_(True)
            loss = self._objective(w.to(torch.float64), b.to(torch.float64),
                                   xs, y)
            gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                w = _soft_threshold(w - self.lr * gw, lam)
                b = b - self.lr * gb
        w = w.cpu().numpy() / sd.cpu().numpy()
        self.weights = w.astype(np.float32)
        self.bias = float(b.cpu().numpy() - np.dot(w, mu.cpu().numpy()))
        self.feature_names = list(feature_names) if feature_names else None
        return self

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

    def _objective(self, w, b, x, y):
        pred = x @ w + b
        return torch.mean((pred - y) ** 2)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.decision_function(x)


class LogisticRegression(_LinearBase):
    kind = "logistic_regression"

    def _objective(self, w, b, x, y):
        # term for term the JAX package's loss (not binary_cross_entropy_
        # with_logits, whose gradient rounds otherwise); torch.maximum
        # splits the gradient at a tie 0.5 / 0.5 as jnp.maximum does
        logits = x @ w + b
        return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                          - logits * y
                          + torch.log1p(torch.exp(-_abs(logits))))

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return rowwise_sigmoid(self.decision_function(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.decision_function(x) > 0).to(torch.int32)
