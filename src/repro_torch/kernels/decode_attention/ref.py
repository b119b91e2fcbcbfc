"""Plain torch version of the decode-attention kernel.  CPU tensors take
this path; on the card it is the version the CUDA kernel is held against.
Like the TPU kernel (and the CUDA one) it rounds the probabilities to v's
dtype before the P.V product and divides by the unrounded sum, clamped at
1e-30."""

from __future__ import annotations

import math

import torch

__all__ = ["decode_attention_ref"]

_NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         softcap: float = 0.0) -> torch.Tensor:
    """q [B,1,H,D]; caches [B,T,KV,D]; cache_len [B] -> [B,1,H,D] in q's
    dtype.  Slots at or beyond ``cache_len[b]`` are masked."""
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) \
        * (1.0 / math.sqrt(d))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(t, device=q.device)[None, :] \
        < cache_len.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, _NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float()) / l.clamp_min(1e-30)
    return out.reshape(b, 1, h, d).to(q.dtype)
