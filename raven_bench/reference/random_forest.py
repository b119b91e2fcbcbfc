"""Plain reference of a random forest pipeline: a standard scaler, then the
mean of the trees' class scores; PREDICT is the class with the highest mean
score (the first on a tie) and PREDICT_PROBA the softmax of the mean scores'
positive class.  Plain torch from the model's plain state; no kernel, no
cache, no batching.

The configuration states its features in float32, scaled as ``(x - mean)
* float32(1 / std)`` (the program's scaler, and the JAX package's under
XLA, which rewrites the division so): the reference scales so, and a tree
then takes the same branch as the program at every node.  The leaves are
multiples of a power of two, so their mean is exact in any order.  The
rest, and everything in the control's ``bfloat16``, runs in ``dtype``.

With ``fold`` the scaler is folded into the trees, as Raven's inlining
rewrites it: each node compares the raw feature with ``threshold * std +
mean``, the same function in another order of float operations."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def outputs(state: Dict, columns: Dict[str, np.ndarray], dtype: torch.dtype,
            device: torch.device, block: int = 1 << 20, fold: bool = False
            ) -> Dict[str, np.ndarray]:
    """{"predict", "proba"} for every row of ``columns``, computed in
    ``dtype`` on ``device`` in blocks of ``block`` rows."""
    sc = state["featurizers"][0]
    trees = state["model"]["trees"]

    def put(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

    xdt = torch.float32 if dtype == torch.float64 else dtype
    mean = put(sc["mean"], xdt)
    inv_std = put(np.float32(1.0) / np.asarray(sc["std"], np.float32), xdt)
    feature = put(np.stack([t["feature"] for t in trees]), torch.int64)
    thr = np.stack([t["threshold"] for t in trees])
    if fold:
        feat = np.maximum(np.stack([t["feature"] for t in trees]), 0)
        std32 = np.asarray(sc["std"], np.float32)
        mean32 = np.asarray(sc["mean"], np.float32)
        thr = thr.astype(np.float32) * std32[feat] + mean32[feat]
    threshold = put(thr)
    left = put(np.stack([t["left"] for t in trees]), torch.int64)
    right = put(np.stack([t["right"] for t in trees]), torch.int64)
    value = put(np.stack([t["value"] for t in trees]))
    depth = max(int(t["depth"]) for t in trees)
    n = len(columns[sc["columns"][0]])
    predict, proba = [], []
    for a in range(0, n, block):
        x = torch.stack([put(columns[c][a:a + block], xdt)
                         for c in sc["columns"]], 1)
        x = (x if fold else (x - mean) * inv_std).to(dtype)
        total = torch.zeros((x.shape[0], value.shape[2]), dtype=dtype,
                            device=device)
        for j in range(len(trees)):
            node = torch.zeros(x.shape[0], dtype=torch.int64, device=device)
            for _ in range(depth):
                xf = x.gather(1, feature[j][node][:, None])[:, 0]
                nxt = torch.where(xf <= threshold[j][node], left[j][node],
                                  right[j][node])
                node = torch.where(left[j][node] < 0, node, nxt)
            total = total + value[j][node]
        avg = total / len(trees)
        predict.append(torch.argmax(avg, 1).to(torch.float64))
        proba.append(torch.softmax(avg, 1)[:, 1].to(torch.float64))
    return {"predict": torch.cat(predict).cpu().numpy(),
            "proba": torch.cat(proba).cpu().numpy()}
