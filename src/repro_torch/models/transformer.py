"""LM assembly for the dense, full-attention family (the JAX package's
``models/transformer.py``, dense branch, inference only).

``LanguageModel(cfg, device)`` exposes:

- ``param_template() / init_params(generator)``: the parameters as a nested
  dict, with ``"layers"`` a list of per-layer dicts (the JAX package stacks
  them on a leading ``[L, ...]`` axis; ``models.convert`` carries them
  across);
- ``prefill(params, tokens, max_len)``: full-sequence forward returning the
  last position's logits and a decode cache of capacity ``max_len``;
- ``decode_step(params, cache, tokens)``: one token for every batch row;
- ``cache_specs(batch, max_len)``: shapes and dtypes of the decode cache.

Mixed precision follows the JAX package: parameters are kept in
``param_dtype`` (float32 by default), each layer computes in bfloat16, the
KV cache is bfloat16, logits are float32.  Attention goes through the
kernel wrappers (``models.attention``): hand-written CUDA kernels on the
card, their plain versions on the CPU.

``build_model`` raises ``NotImplementedError`` for every family or option
the port does not carry yet, naming it: local/global and sliding-window
attention (ring caches), RWKV, hybrid SSM, mixture of experts,
encoder-decoder and multimodal frontends.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..relational.table import resolve_device
from . import attention as attn_mod
from .layers import dense_init, init_params, mlp_apply, mlp_params, rms_norm, \
    softcap

__all__ = ["LanguageModel", "build_model"]

_NEG_INF = -1e30


def _cast(tree, dtype: torch.dtype):
    """Float leaves of a (nested dict) parameter tree in ``dtype``; a leaf
    already in it is returned as is."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _unported_reason(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet, or None if it can."""
    if cfg.rwkv:
        return "the RWKV-6 recurrence (family rwkv)"
    if cfg.hybrid:
        return "hybrid attention + SSM heads (family hybrid)"
    if cfg.is_encdec:
        return "encoder-decoder models (family encdec)"
    if cfg.n_experts > 0:
        return "mixture of experts (family moe)"
    if cfg.frontend != "none":
        return f"the {cfg.frontend} frontend (family {cfg.family})"
    if cfg.attention != "full":
        return (f"{cfg.attention} attention (sliding-window ring-buffer "
                f"caches)")
    if cfg.family != "dense":
        return f"family {cfg.family}"
    return None


class LanguageModel:
    """Dense, full-attention decoder LM on one device.

    ``device=None`` means the card and raises without one; pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: ModelConfig, device: Any = None,
                 param_dtype: torch.dtype = torch.float32):
        reason = _unported_reason(cfg)
        if reason is not None:
            raise NotImplementedError(
                f"{cfg.name}: {reason} is not ported to repro_torch yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = param_dtype
        self.kv_cache_dtype = torch.bfloat16

    # ------------------------------------------------------------------ params
    def _layer_template(self) -> Dict:
        d = self.cfg.d_model
        return {"ln1": dense_init(d, init="zeros"),
                "ln2": dense_init(d, init="zeros"),
                "attn": attn_mod.attention_params(self.cfg),
                "mlp": mlp_params(d, self.cfg.d_ff, self.cfg.act)}

    def param_template(self) -> Dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_padded
        tpl: Dict[str, Any] = {
            "embed": dense_init(v, d, scale=0.02),
            "final_norm": dense_init(d, init="zeros"),
            "layers": [self._layer_template() for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            tpl["lm_head"] = dense_init(d, v)
        return tpl

    def init_params(self, generator: torch.Generator) -> Dict:
        """Random parameters under the JAX package's init rule, drawn from
        ``generator`` and placed on the model's device."""
        return init_params(self.param_template(), generator,
                           self.param_dtype, self.device)

    # --------------------------------------------------------------- embedding
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> h [B,S,D] bfloat16 (scaled in the param dtype)."""
        h = params["embed"][tokens.to(self.device, torch.long)]
        return (h * self.cfg.embed_scale).to(torch.bfloat16)

    def _logits(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = (h @ head.to(h.dtype)).float() * cfg.logit_scale
        logits = softcap(logits, cfg.final_softcap)
        if cfg.vocab_padded > cfg.vocab_size:
            logits[..., cfg.vocab_size:] = _NEG_INF
        return logits

    # ----------------------------------------------------------------- blocks
    def _block_seq(self, lp, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence block (prefill).  Returns (h, {"k", "v"})."""
        cfg = self.cfg
        rs = cfg.residual_scale
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, lp["attn"], x)
        out = attn_mod.full_attention(cfg, q, k, v, mask_kind="causal")
        b, s = out.shape[:2]
        h = h + rs * (out.reshape(b, s, cfg.q_dim) @ lp["attn"]["wo"])
        y = mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                      cfg.act)
        h = h + rs * y
        return h, {"k": k.to(self.kv_cache_dtype),
                   "v": v.to(self.kv_cache_dtype)}

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, tokens: torch.Tensor,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B,S] -> (last-position logits [B,V_padded] float32, decode
        cache of capacity ``max_len`` (default S + 64))."""
        h = self._embed(params, tokens)
        seq_len = h.shape[1]
        max_len = max_len or seq_len + 64
        caches = []
        for lp in params["layers"]:
            h, kv = self._block_seq(_cast(lp, torch.bfloat16), h)
            caches.append(kv)
        logits = self._logits(params, h[:, -1:])
        cache = {"len": torch.full((h.shape[0],), seq_len, dtype=torch.int32,
                                   device=self.device),
                 "layers": self._prefill_caches_to_decode(caches, seq_len,
                                                          max_len)}
        return logits[:, 0], cache

    def _prefill_caches_to_decode(self, caches: List[Dict], seq_len: int,
                                  max_len: int) -> List[Dict]:
        """Per-layer prefill k/v [B,S,Kv,hd] -> full-capacity decode buffers
        [B,max_len,Kv,hd], zero past the prompt."""
        if seq_len > max_len:
            raise ValueError(f"prefill: prompt of {seq_len} tokens exceeds "
                             f"the cache capacity max_len={max_len}")
        out = []
        for kv in caches:
            entry = {}
            for name in ("k", "v"):
                x = kv[name]
                buf = torch.zeros((x.shape[0], max_len) + tuple(x.shape[2:]),
                                  dtype=self.kv_cache_dtype,
                                  device=self.device)
                buf[:, :seq_len] = x
                entry[name] = buf
            out.append(entry)
        return out

    # ----------------------------------------------------------------- decode
    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """Decode-cache (shape, dtype) pairs, in the cache's structure."""
        cfg = self.cfg
        kv = ((batch, max_len, cfg.n_kv_heads, cfg.d_head),
              self.kv_cache_dtype)
        return {"len": ((batch,), torch.int32),
                "layers": [{"k": kv, "v": kv} for _ in range(cfg.n_layers)]}

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B,1] -> (logits [B,V_padded] float32, cache advanced one
        position).  Unlike the JAX package, which returns new buffers, the
        new token's k/v are written into the cache's buffers in place (at
        full width a copy would move the whole cache every step)."""
        pos = cache["len"]                                   # [B] int32
        h = self._embed(params, tokens)
        for lp, lc in zip(params["layers"], cache["layers"]):
            h = self._decode_block(_cast(lp, torch.bfloat16), lc, h, pos)
        logits = self._logits(params, h)[:, 0]
        return logits, dict(cache, len=pos + 1)

    def _decode_block(self, lp, lc, h: torch.Tensor, pos: torch.Tensor
                      ) -> torch.Tensor:
        cfg = self.cfg
        rs = cfg.residual_scale
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        b = x.shape[0]
        q, k, v = attn_mod.project_qkv(cfg, lp["attn"], x,
                                       positions=pos[:, None])
        cap = lc["k"].shape[1]
        slot = torch.clamp(pos, max=cap - 1).long()
        rows = torch.arange(b, device=x.device)
        lc["k"][rows, slot] = k[:, 0].to(lc["k"].dtype)
        lc["v"][rows, slot] = v[:, 0].to(lc["v"].dtype)
        valid_len = torch.clamp(pos + 1, max=cap)
        out = attn_mod.decode_attention(cfg, q, lc["k"], lc["v"], valid_len)
        h = h + rs * (out.reshape(b, 1, cfg.q_dim) @ lp["attn"]["wo"])
        y = mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                      cfg.act)
        return h + rs * y


def build_model(cfg: ModelConfig, device: Any = None,
                param_dtype: torch.dtype = torch.float32) -> LanguageModel:
    """A ``LanguageModel`` for ``cfg``; raises ``NotImplementedError`` for
    a family or option the port does not carry yet."""
    return LanguageModel(cfg, device=device, param_dtype=param_dtype)
