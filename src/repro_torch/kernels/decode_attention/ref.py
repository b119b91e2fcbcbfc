"""Plain torch versions of the decode-attention kernel.

``decode_attention_ref`` is the function itself.  CPU tensors take this
path; on the card it is the version the CUDA kernel is held against.  Like
the TPU kernel (and the CUDA one) it rounds the probabilities to v's dtype
before the P.V product and divides by the unrounded sum, clamped at 1e-30.

``decode_attention_split_ref`` mirrors the CUDA kernel's split of the cache
and its combine (``csrc/decode_attention.cu``), so the CPU tests can pin
the kernel's algorithm; nothing on the model's path calls it."""

from __future__ import annotations

import math

import torch

__all__ = ["decode_attention_ref", "decode_attention_split_ref"]

_NEG_INF = -1e30


def _scores(q, k_cache, cache_len, softcap):
    """[B,KV,G,T] float32 scores, masked to -1e30 at or past cache_len."""
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) \
        * (1.0 / math.sqrt(d))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(t, device=q.device)[None, :] \
        < cache_len.to(q.device)[:, None]
    return torch.where(valid[:, None, None, :], s, _NEG_INF)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         softcap: float = 0.0) -> torch.Tensor:
    """q [B,1,H,D]; caches [B,T,KV,D]; cache_len [B] -> [B,1,H,D] in q's
    dtype.  Slots at or beyond ``cache_len[b]`` are masked."""
    s = _scores(q, k_cache, cache_len, softcap)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float()) / l.clamp_min(1e-30)
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, cache_len: torch.Tensor,
                               softcap: float = 0.0,
                               n_splits: int = 1) -> torch.Tensor:
    """The kernel's two passes, with the cache cut into splits of
    ceil(T / n_splits) slots (the last may be shorter):

    (1) per split, over the slots it reads (those below n = cache_len,
        clamped to T; all of them where cache_len <= 0), the split's max
        m_s, l_s = sum exp(s - m_s) and acc_s = sum round_v(exp(s - m_s)) v;
        a split that reads no slot is empty (m_s = -1e30, l_s = 0);
    (2) over the non-empty splits, M = max m_s, w_s = exp(m_s - M) and
        out = sum w_s acc_s / max(sum w_s l_s, 1e-30)."""
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    split_len = -(-t // n_splits)
    n = -(-t // split_len)
    pad = n * split_len - t
    s = torch.nn.functional.pad(_scores(q, k_cache, cache_len, softcap),
                                (0, pad))
    lens = cache_len.to(q.device).long()
    n_read = torch.where(lens >= 1, lens.clamp(max=t), t)
    read = torch.arange(n * split_len, device=q.device)[None, :] \
        < n_read[:, None]                                    # [B,T']
    s = torch.where(read[:, None, None, :], s, -math.inf)
    s = s.reshape(b, kv, g, n, split_len)
    m = s.amax(-1)                                           # [B,KV,G,n]
    m = torch.where(torch.isinf(m), _NEG_INF, m)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    vs = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("bkgnt,bntkd->bkgnd", p.to(v_cache.dtype).float(),
                       vs.reshape(b, n, split_len, kv, d))
    full = l > 0
    mx = torch.where(full, m, -math.inf).amax(-1, keepdim=True)
    w = torch.where(full, torch.exp(m - mx), 0.0)
    out = (w[..., None] * acc).sum(-2) \
        / (w * l).sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(q.shape).to(q.dtype)
