"""Plain torch version of the flash-attention kernel: the score matrix is
materialized.  CPU tensors take this path; on the card it is the version
the CUDA kernel is held against.  Like the TPU kernel (and the CUDA one) it
rounds the probabilities to v's dtype before the P.V product and divides by
the unrounded sum, clamped at 1e-30.  ``attention_with_lse_ref`` also
returns each row's log-sum-exp, as the JAX package's blockwise forward
computes it for its backward: m + log(max(l, 1e-30)), m the row's largest
(masked) score and l the unrounded sum of exp(score - m)."""

from __future__ import annotations

import math

import torch

from typing import Tuple

__all__ = ["attention_ref", "attention_with_lse_ref"]

_NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q [B,S,H,D]; k,v [B,T,KV,D] -> [B,S,H,D] in q's dtype.  Query head h
    attends KV head h // (H/KV); ``window > 0`` (with ``causal``) keeps the
    last ``window`` positions."""
    return attention_with_lse_ref(q, k, v, causal, window, softcap)[0]


def attention_with_lse_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: int = 0, softcap: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref``'s output and each row's log-sum-exp, float32
    [B,H,S] (the JAX package's [B,KV,G,S] read flat).  A row that sees no
    key has every score at -1e30, and its lse is -1e30."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) \
        * (1.0 / math.sqrt(d))
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    if causal:
        diff = torch.arange(s, device=q.device)[:, None] \
            - torch.arange(t, device=q.device)[None, :]
        mask = diff >= 0
        if window > 0:
            mask = mask & (diff < window)
        scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    out = pv / l.clamp_min(1e-30)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0].reshape(b, h, s)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype), lse
