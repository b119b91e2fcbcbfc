"""GQA attention for inference: projections, full-sequence attention
(prefill) and one-token attention over a KV cache (decode), the JAX
package's ``models/attention.py`` without the training VJP.

Both attention functions go through the kernel wrappers: on a CUDA tensor
``full_attention`` launches the hand-written flash-attention kernel and
``decode_attention`` the decode-attention kernel; on a CPU tensor the same
wrappers take their plain versions.  GQA: query head h attends KV head
h // (H / KV).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops
from .layers import apply_rope, dense_init, rms_norm, rope

__all__ = ["attention_params", "project_qkv", "full_attention",
           "decode_attention"]


def attention_params(cfg) -> Dict:
    d = cfg.d_model
    p = {"wq": dense_init(d, cfg.q_dim), "wk": dense_init(d, cfg.kv_dim),
         "wv": dense_init(d, cfg.kv_dim), "wo": dense_init(cfg.q_dim, d)}
    if cfg.qkv_bias:
        p["bq"] = dense_init(cfg.q_dim, init="zeros")
        p["bk"] = dense_init(cfg.kv_dim, init="zeros")
        p["bv"] = dense_init(cfg.kv_dim, init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = dense_init(cfg.d_head, init="zeros")
        p["k_norm"] = dense_init(cfg.d_head, init="zeros")
    return p


def project_qkv(cfg, p: Dict, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                use_rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,Kv,hd], RoPE applied at
    ``positions`` ([B,S] or [1,S]; default 0..S-1) unless ``use_rope`` is
    False (cross-attention's queries)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not use_rope:
        return q.contiguous(), k.contiguous(), v.contiguous()
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sin, cos = rope(positions, cfg.d_head, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v.contiguous()


def full_attention(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask_kind: str = "causal",
                   window: Optional[int] = None) -> torch.Tensor:
    """q [B,S,H,hd]; k,v [B,T,Kv,hd] -> [B,S,H,hd].

    ``mask_kind``: "causal", "window" (causal, last ``window`` positions;
    None means ``cfg.window_size``), or "bidir"/"cross" (no mask).  A
    ``window`` <= 0 disables the window."""
    if mask_kind not in ("causal", "window", "bidir", "cross"):
        raise ValueError(f"full_attention: unknown mask kind {mask_kind!r}")
    if window is None:
        window = cfg.window_size if mask_kind == "window" else 0
    return flash_ops.flash_attention(
        q, k, v, causal=mask_kind in ("causal", "window"),
        window=max(int(window), 0), softcap=float(cfg.attn_softcap))


def decode_attention(cfg, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor
                     ) -> torch.Tensor:
    """One-token attention over a KV cache.  q [B,1,H,hd]; caches
    [B,C,Kv,hd]; ``cache_len`` [B] int32 = valid entries (the new token's
    k/v already written)."""
    return decode_ops.decode_attention(q, k_cache, v_cache, cache_len,
                                       softcap=float(cfg.attn_softcap))
