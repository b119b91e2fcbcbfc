"""Small MLP model (the paper's Fig 3 uses an MLP pipeline).  ``fit`` runs
plain SGD on ``torch.autograd``, on the card unless ``device=`` asks for
the CPU; the fitted layers are numpy ``[{"w", "b"}]``, as
``repro_torch.ml.convert`` builds them, and inference places them on the
input's device."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .linear import fit_tensors, rowwise_matmul

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

    def _init(self, d_in: int) -> List[dict]:
        """He-normal weights and zero biases, float32, drawn from a CPU
        ``torch.Generator`` seeded with ``self.seed`` (a fit on the card
        starts from the same parameters as one on the CPU)."""
        gen = torch.Generator().manual_seed(self.seed)
        dims = [d_in] + self.hidden + [self.n_outputs]
        return [{"w": torch.randn((dims[i], dims[i + 1]), generator=gen)
                 * float(np.sqrt(2.0 / dims[i])),
                 "b": torch.zeros(dims[i + 1])}
                for i in range(len(dims) - 1)]

    @staticmethod
    def apply(params, x: torch.Tensor) -> torch.Tensor:
        """Layers are ``h @ w + b`` (row by row, ``rowwise_matmul``) with
        ReLU between; ``params`` hold tensors on ``x``'s device."""
        h = x
        for i, layer in enumerate(params):
            h = rowwise_matmul(h, layer["w"]) + layer["b"]
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    def fit(self, x: Any, y: Any,
            feature_names: Optional[Sequence[str]] = None, *,
            device: Any = None) -> "MLP":
        """``steps`` of plain SGD from :meth:`_init`: log-softmax NLL for
        classification, MSE on output 0 for regression; float32 on
        ``device`` (see :func:`~repro_torch.ml.linear.fit_tensors`)."""
        classify = self.task == "classification"
        x, y = fit_tensors(x, y, device,
                           torch.int64 if classify else torch.float32)
        params = [torch.as_tensor(p[k], dtype=torch.float32,
                                  device=x.device)
                  for p in self._init(x.shape[1]) for k in ("w", "b")]

        def loss(params):
            # training runs whole-batch GEMMs (no row-local bits needed)
            h = x
            for i in range(0, len(params), 2):
                h = h @ params[i] + params[i + 1]
                if i < len(params) - 2:
                    h = torch.relu(h)
            if classify:
                logp = torch.log_softmax(h, dim=-1)
                return -torch.mean(logp.gather(1, y[:, None]))
            return torch.mean((h[:, 0] - y) ** 2)

        for _ in range(self.steps):
            for p in params:
                p.requires_grad_(True)
            grads = torch.autograd.grad(loss(params), params)
            with torch.no_grad():
                params = [p - self.lr * g for p, g in zip(params, grads)]
        host = [p.cpu().numpy() for p in params]
        self.params = [{"w": host[i], "b": host[i + 1]}
                       for i in range(0, len(host), 2)]
        self.feature_names = list(feature_names) if feature_names else None
        return self

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
