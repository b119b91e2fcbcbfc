"""Small MLP model (the paper's Fig 3 uses an MLP pipeline): inference on
tensors.  The JAX package trains it with ``jax.grad``; that fit is not
ported yet, so the port builds an MLP from fitted ``[{"w", "b"}]`` layers
(``repro_torch.ml.convert``) and only infers."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["MLP"]


class MLP:
    kind = "mlp"

    def __init__(self, hidden: Sequence[int] = (64, 32), n_outputs: int = 2,
                 task: str = "classification", lr: float = 1e-2,
                 steps: int = 300, seed: int = 0):
        self.hidden = list(hidden)
        self.n_outputs = n_outputs
        self.task = task
        self.lr = lr
        self.steps = steps
        self.seed = seed
        self.params: Optional[List] = None     # [{"w": [d_in, d_out], "b"}]
        self.feature_names: Optional[List[str]] = None

    @staticmethod
    def apply(params, x: torch.Tensor) -> torch.Tensor:
        """Layers are ``h @ w + b`` with ReLU between; ``params`` hold
        tensors on ``x``'s device."""
        h = x
        for i, layer in enumerate(params):
            h = h @ layer["w"] + layer["b"]
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    def fit(self, x: np.ndarray, y: np.ndarray,
            feature_names: Optional[Sequence[str]] = None) -> "MLP":
        raise NotImplementedError(
            "MLP.fit is not ported yet; build the model from fitted layers "
            "with repro_torch.ml.convert")

    def scorer(self, device):
        """Raw scores [n, n_outputs] with the layers placed on ``device``."""
        params = [{k: torch.as_tensor(np.asarray(p[k], np.float32),
                                      device=device) for k in ("w", "b")}
                  for p in self.params]
        return lambda x: self.apply(params, x.to(torch.float32))

    def predict_scores(self, x: torch.Tensor) -> torch.Tensor:
        return self.scorer(x.device)(x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        scores = self.predict_scores(x)
        if self.task == "classification":
            return torch.argmax(scores, dim=-1).to(torch.int32)
        return scores[:, 0]

    def first_layer_weights(self) -> np.ndarray:
        return np.asarray(self.params[0]["w"])

    def restrict_features(self, keep: np.ndarray) -> "MLP":
        clone = MLP(self.hidden, self.n_outputs, self.task, self.lr,
                    self.steps, self.seed)
        params = [dict(p) for p in self.params]
        params[0] = {"w": np.asarray(self.params[0]["w"])[np.asarray(keep)],
                     "b": self.params[0]["b"]}
        clone.params = params
        if self.feature_names:
            clone.feature_names = [self.feature_names[i] for i in keep]
        return clone
