"""Plain reference of a one-hot + scaler + logistic regression pipeline:
the logit is the bias plus, for each one-hot column, the weight of the
row's code (none if the code is outside the column's categories) plus, for
each scaled column, its weight times (x - mean) / std; PREDICT_PROBA is the
logit's sigmoid and PREDICT whether the logit is above 0.  Plain torch, in
the precision it is given, from the model's plain state.

With ``fold`` the scaler is folded into the model, as Raven's inlining
rewrites it: each scaled column's weight becomes ``w / std`` and the
shifts ``-w * mean / std`` join the bias, the same function in another
order of float operations."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def outputs(state: Dict, columns: Dict[str, np.ndarray], dtype: torch.dtype,
            device: torch.device, block: int = 1 << 22, fold: bool = False
            ) -> Dict[str, np.ndarray]:
    """{"predict", "proba"} for every row of ``columns``, computed in
    ``dtype`` on ``device`` in blocks of ``block`` rows."""
    def put(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

    w = np.asarray(state["model"]["weights"], np.float32)
    terms, off = [], 0
    for f in state["featurizers"]:
        if f["kind"] == "one_hot":
            for c in f["columns"]:
                cats = np.asarray(f["categories"][c]).astype(np.int64)
                lut = np.zeros(int(cats.max()) + 2, np.float32)
                lut[cats] = w[off:off + len(cats)]
                off += len(cats)
                terms.append(("one_hot", c, put(lut)))
        else:
            for i, c in enumerate(f["columns"]):
                terms.append(("scaled", c, (put(f["mean"][i]),
                                            put(f["std"][i]),
                                            put(w[off]))))
                off += 1
    bias = put(state["model"]["bias"])
    if fold:
        for i, (kind, c, p) in enumerate(terms):
            if kind == "scaled":
                mean, std, wc = p
                terms[i] = ("folded", c, wc / std)
                bias = bias - mean * (wc / std)
    n = len(columns[terms[0][1]])
    predict, proba = [], []
    for a in range(0, n, block):
        logit = None
        for kind, c, p in terms:
            col = torch.as_tensor(np.asarray(columns[c][a:a + block]))
            if kind == "one_hot":
                code = col.to(device=device, dtype=torch.int64)
                outside = (code < 0) | (code >= p.shape[0] - 1)
                term = p[torch.where(outside, p.shape[0] - 1, code)]
            elif kind == "folded":
                term = col.to(device=device, dtype=dtype) * p
            else:
                mean, std, wc = p
                term = (col.to(device=device, dtype=dtype) - mean) / std * wc
            logit = term if logit is None else logit + term
        logit = logit + bias
        predict.append((logit > 0).to(torch.float64))
        proba.append(torch.sigmoid(logit).to(torch.float64))
    return {"predict": torch.cat(predict).cpu().numpy(),
            "proba": torch.cat(proba).cpu().numpy()}
