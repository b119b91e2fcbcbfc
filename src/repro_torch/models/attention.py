"""GQA attention: projections, full-sequence attention (prefill and
training) with the flash backward, and one-token attention over a KV cache
(decode), the JAX package's ``models/attention.py``.

Both attention functions go through the kernel wrappers: on a CUDA tensor
``full_attention`` launches the hand-written flash-attention kernel and
``decode_attention`` the decode-attention kernel; on a CPU tensor the same
wrappers take their plain versions.  GQA: query head h attends KV head
h // (H / KV).

Under a gradient ``full_attention`` goes through ``FlashAttention``, the
counterpart of the JAX package's ``jax.custom_vjp`` ``_flash``: its forward
is the same kernel, now also writing each row's log-sum-exp, and it saves
only (q, k, v, out, lse); its backward, ``flash_attention_bwd``, is the JAX
package's ``_flash_bwd`` line by line in plain torch (the JAX backward is
plain JAX too, not a Pallas kernel): float32 throughout, D = rowsum(dO.O),
key blocks of ``block_size`` in order, score blocks recomputed from the
saved lse, the soft cap's tanh chain rule.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops
from .layers import apply_rope, dense_init, rms_norm, rope

__all__ = ["attention_params", "project_qkv", "full_attention",
           "decode_attention", "FlashAttention", "flash_attention_bwd"]

_NEG_INF = -1e30


def attention_params(cfg) -> Dict:
    d = cfg.d_model
    p = {"wq": dense_init((d, "embed"), (cfg.q_dim, "heads")),
         "wk": dense_init((d, "embed"), (cfg.kv_dim, "kv")),
         "wv": dense_init((d, "embed"), (cfg.kv_dim, "kv")),
         "wo": dense_init((cfg.q_dim, "heads"), (d, "embed"))}
    if cfg.qkv_bias:
        p["bq"] = dense_init((cfg.q_dim, "heads"), init="zeros")
        p["bk"] = dense_init((cfg.kv_dim, "kv"), init="zeros")
        p["bv"] = dense_init((cfg.kv_dim, "kv"), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = dense_init((cfg.d_head, None), init="zeros")
        p["k_norm"] = dense_init((cfg.d_head, None), init="zeros")
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


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: int, t_valid: int) -> torch.Tensor:
    """[S, bk] boolean mask (the JAX package's ``_block_mask``): keys past
    ``t_valid`` masked; causal keeps q - k >= 0, and < ``window`` where
    ``window`` > 0."""
    base = (k_pos < t_valid)[None, :]
    if not causal:
        return base.expand(q_pos.shape[0], k_pos.shape[0])
    diff = q_pos[:, None] - k_pos[None, :]
    mask = (diff >= 0) & base
    if window > 0:
        mask = mask & (diff < window)
    return mask


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool, window: int,
                        softcap: float, block_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward from the forward's saved (q, k, v, out, lse):
    q [B,S,H,hd], k/v [B,T,Kv,hd], out like q, lse float32 [B,H,S], dout
    like out -> (dq, dk, dv) in q's, k's and v's dtypes.  The key axis goes
    in blocks of ``block_size``, in order; the last block is cut short
    where the JAX package pads it with masked zero keys, which add nothing
    to the kept gradients."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    bk = min(block_size, t)
    qg = q.reshape(b, s, kv, g, hd).float()
    dog = dout.reshape(b, s, kv, g, hd).float()
    outg = out.reshape(b, s, kv, g, hd).float()
    lse_g = lse.reshape(b, kv, g, s, 1)
    dsum = torch.einsum("bskgd,bskgd->bkgs", dog, outg)[..., None]
    q_pos = torch.arange(s, device=q.device)
    dq = torch.zeros((b, s, kv, g, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start in range(0, t, bk):
        k_blk = k[:, start:start + bk].float()
        v_blk = v[:, start:start + bk].float()
        k_pos = torch.arange(start, start + k_blk.shape[1], device=q.device)
        raw = torch.einsum("bskgd,btkd->bkgst", qg, k_blk) * scale
        if softcap > 0:
            tanh_t = torch.tanh(raw / softcap)
            scores = softcap * tanh_t
            chain = 1.0 - tanh_t * tanh_t
        else:
            scores, chain = raw, None
        mask = _block_mask(q_pos, k_pos, causal, window, t)
        scores = torch.where(mask, scores, _NEG_INF)
        p = torch.exp(scores - lse_g)                  # exact probabilities
        dvs.append(torch.einsum("bkgst,bskgd->btkd", p, dog))
        dp = torch.einsum("bskgd,btkd->bkgst", dog, v_blk)
        ds = p * (dp - dsum)
        if chain is not None:
            ds = ds * chain
        ds = ds * scale
        dq = dq + torch.einsum("bkgst,btkd->bskgd", ds, k_blk)
        dks.append(torch.einsum("bkgst,bskgd->btkd", ds, qg))
    return (dq.reshape(b, s, h, hd).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: the forward launches the flash
    kernel (its plain version on the CPU) with the log-sum-exp and saves
    (q, k, v, out, lse); the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float,
                block_size: int):
        out, lse = flash_ops.flash_attention_with_lse(q, k, v, causal,
                                                      window, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = (causal, window, softcap, block_size)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # a profiler range: a trace reads the backward's device time by it
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                             *ctx.options)
        return dq, dk, dv, None, None, None, None


def full_attention(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask_kind: str = "causal",
                   window: Optional[int] = None,
                   block_size: int = 512,
                   use_flash_vjp: bool = True) -> torch.Tensor:
    """q [B,S,H,hd]; k,v [B,T,Kv,hd] -> [B,S,H,hd].

    ``mask_kind``: "causal", "window" (causal, last ``window`` positions;
    None means ``cfg.window_size``), or "bidir"/"cross" (no mask).  A
    ``window`` <= 0 disables the window.  When grad mode is on and an input
    requires grad, ``use_flash_vjp`` sends the call through
    ``FlashAttention`` (whose backward scans keys in blocks of
    ``block_size``); otherwise it is one wrapper call, as in inference.
    Without the flash VJP a gradient exists on the CPU only (autograd
    through the plain version); the card's kernel refuses one."""
    if mask_kind not in ("causal", "window", "bidir", "cross"):
        raise ValueError(f"full_attention: unknown mask kind {mask_kind!r}")
    if window is None:
        window = cfg.window_size if mask_kind == "window" else 0
    causal = mask_kind in ("causal", "window")
    window = max(int(window), 0)
    cap = float(cfg.attn_softcap)
    if use_flash_vjp and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, cap,
                                    block_size)
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cap)


def decode_attention(cfg, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor
                     ) -> torch.Tensor:
    """One-token attention over a KV cache.  q [B,1,H,hd]; caches
    [B,C,Kv,hd]; ``cache_len`` [B] int32 = valid entries (the new token's
    k/v already written)."""
    return decode_ops.decode_attention(q, k_cache, v_cache, cache_len,
                                       softcap=float(cfg.attn_softcap))
