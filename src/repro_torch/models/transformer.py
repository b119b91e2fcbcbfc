"""LM assembly (the JAX package's ``models/transformer.py``, inference
only) for three families: dense full attention (MiniCPM, Phi-3, Qwen2.5),
RWKV-6 (attention-free, the WKV6 recurrence) and Hymba (parallel attention
and SSM heads, sliding-window attention with a few global layers).

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
KV cache is bfloat16, logits are float32.  Like the JAX prefill, the
residual stream goes back to bfloat16 after every layer; like the JAX
decode, it does not (an RWKV layer's float32 output then carries on).
Attention, the WKV6 recurrence and the SSD scan go through the kernel
wrappers (``models.attention``, ``models.rwkv6``, ``models.ssm``):
hand-written CUDA kernels on the card, their plain versions on the CPU.

The decode cache is heterogeneous per layer, as in the JAX package: k/v
buffers of capacity ``max_len`` for global attention layers, ring buffers
of ``window`` slots (slot = position % window) for sliding-window layers,
the SSM's conv and SSD states beside them for Hymba, and the token shifts
and WKV state for RWKV-6.

``build_model`` raises ``NotImplementedError`` for every family or option
the port does not carry yet, naming it: gemma2's local/global alternation,
mixture of experts, encoder-decoder and multimodal frontends.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..relational.table import resolve_device
from . import attention as attn_mod
from . import rwkv6 as rwkv_mod
from . import ssm as ssm_mod
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
    if cfg.is_encdec:
        return "encoder-decoder models (family encdec)"
    if cfg.n_experts > 0:
        return "mixture of experts (family moe)"
    if cfg.frontend != "none":
        return f"the {cfg.frontend} frontend (family {cfg.family})"
    if cfg.attention == "local_global":
        return (f"gemma2's local/global attention alternation (family "
                f"{cfg.family})")
    return None


class LanguageModel:
    """Decoder LM (dense, RWKV-6 or Hymba) on one device.

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
        cfg = self.cfg
        d = cfg.d_model
        layer = {"ln1": dense_init(d, init="zeros"),
                 "ln2": dense_init(d, init="zeros")}
        if cfg.rwkv:
            layer.update({f"tm_{k}": v for k, v in
                          rwkv_mod.rwkv_params(cfg).items()})
            return layer
        layer["attn"] = attn_mod.attention_params(cfg)
        if cfg.hybrid:
            layer["ssm"] = ssm_mod.ssm_params(cfg)
            layer["fuse_na"] = dense_init(d, init="zeros")
            layer["fuse_ns"] = dense_init(d, init="zeros")
            layer["beta_a"] = dense_init(d, init="ones")
            layer["beta_s"] = dense_init(d, init="ones")
        layer["mlp"] = mlp_params(d, cfg.d_ff, cfg.act)
        return layer

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
    def _layer_flags(self) -> List[bool]:
        """Per layer: attention over the whole prefix (True) or over the
        last ``window_size`` positions (False; Hymba's local layers)."""
        cfg = self.cfg
        if cfg.attention == "swa_global":
            return [i in cfg.global_layers for i in range(cfg.n_layers)]
        return [True] * cfg.n_layers

    def _fuse(self, lp, attn_out: torch.Tensor, ssm_out: torch.Tensor
              ) -> torch.Tensor:
        """Hymba's parallel heads: 0.5 (norm(attn) beta_a + norm(ssm)
        beta_s)."""
        eps = self.cfg.norm_eps
        return 0.5 * (rms_norm(attn_out, lp["fuse_na"], eps) * lp["beta_a"]
                      + rms_norm(ssm_out, lp["fuse_ns"], eps) * lp["beta_s"])

    def _rwkv_block(self, lp, h: torch.Tensor, state: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Time-mix then channel-mix; returns (h, new state).  The time-mix
        output is float32, so h leaves the block in float32, as in JAX."""
        cfg = self.cfg
        rs = cfg.residual_scale
        tm = {k[3:]: v for k, v in lp.items() if k.startswith("tm_")}
        y, st = rwkv_mod.rwkv_time_mix(
            cfg, tm, rms_norm(h, lp["ln1"], cfg.norm_eps), state)
        h = h + rs * y
        y, st2 = rwkv_mod.rwkv_channel_mix(
            cfg, tm, rms_norm(h, lp["ln2"], cfg.norm_eps), state)
        return h + rs * y, {**st, **st2}

    def _block_seq(self, lp, is_global: bool, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence block (prefill).  Returns (h, this layer's cache
        entries: k/v, plus the SSM or RWKV states)."""
        cfg = self.cfg
        if cfg.rwkv:
            return self._rwkv_block(lp, h)
        rs = cfg.residual_scale
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, lp["attn"], x)
        out = attn_mod.full_attention(
            cfg, q, k, v, mask_kind="causal" if is_global else "window")
        b, s = out.shape[:2]
        attn_out = out.reshape(b, s, cfg.q_dim) @ lp["attn"]["wo"]
        cache = {"k": k, "v": v}
        if cfg.hybrid:
            ssm_out, ssm_state = ssm_mod.ssm_apply(cfg, lp["ssm"], x)
            h = h + rs * self._fuse(lp, attn_out, ssm_out)
            cache.update(ssm_state)
        else:
            h = h + rs * attn_out
        y = mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                      cfg.act)
        return h + rs * y, cache

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, tokens: torch.Tensor,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B,S] -> (last-position logits [B,V_padded] float32, decode
        cache of capacity ``max_len`` (default S + 64))."""
        h = self._embed(params, tokens)
        seq_len = h.shape[1]
        max_len = max_len or seq_len + 64
        if seq_len > max_len:
            raise ValueError(f"prefill: prompt of {seq_len} tokens exceeds "
                             f"the cache capacity max_len={max_len}")
        caches = []
        for lp, is_global in zip(params["layers"], self._layer_flags()):
            h, c = self._block_seq(_cast(lp, torch.bfloat16), is_global, h)
            h = h.to(torch.bfloat16)        # the JAX layer scan's carry
            caches.append(c)
        logits = self._logits(params, h[:, -1:])
        cache = {"len": torch.full((h.shape[0],), seq_len, dtype=torch.int32,
                                   device=self.device),
                 "layers": self._prefill_caches_to_decode(
                     caches, h.shape[0], seq_len, max_len)}
        return logits[:, 0], cache

    def _prefill_caches_to_decode(self, caches: List[Dict], batch: int,
                                  seq_len: int, max_len: int) -> List[Dict]:
        """Per-layer prefill entries -> the decode cache of
        ``cache_specs``: k/v [B,S,Kv,hd] into full-capacity buffers (zero
        past the prompt) or, for sliding-window layers, ring buffers holding
        the last ``window`` positions at slot = position % window; states
        copied in the spec's dtype."""
        out = []
        for entries, spec in zip(caches,
                                 self.cache_specs(batch, max_len)["layers"]):
            layer = {}
            for name, (shape, dtype) in spec.items():
                x = entries[name]
                if name not in ("k", "v"):
                    layer[name] = x.to(dtype, copy=True)
                    continue
                buf = torch.zeros(shape, dtype=dtype, device=self.device)
                take = min(shape[1], seq_len)
                slots = torch.arange(seq_len - take, seq_len,
                                     device=self.device) % shape[1]
                buf[:, slots] = x[:, seq_len - take:].to(dtype)
                layer[name] = buf
            out.append(layer)
        return out

    # ----------------------------------------------------------------- decode
    def cache_specs(self, batch: int, max_len: int) -> Dict:
        """Decode-cache (shape, dtype) pairs, in the cache's structure
        (heterogeneous per layer)."""
        cfg = self.cfg
        layers = []
        for is_global in self._layer_flags():
            if cfg.rwkv:
                layers.append(rwkv_mod.rwkv_state_specs(cfg, batch))
                continue
            cap = max_len if is_global else min(cfg.window_size, max_len)
            kv = ((batch, cap, cfg.n_kv_heads, cfg.d_head),
                  self.kv_cache_dtype)
            entry = {"k": kv, "v": kv}
            if cfg.hybrid:
                entry.update(ssm_mod.ssm_state_specs(cfg, batch))
            layers.append(entry)
        return {"len": ((batch,), torch.int32), "layers": layers}

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B,1] -> (logits [B,V_padded] float32, cache advanced one
        position).  Unlike the JAX package, which returns new buffers, the
        new token's k/v and every layer's new states are written into the
        cache's buffers in place (at full width a copy would move the whole
        cache every step); the buffers keep their dtypes."""
        pos = cache["len"]                                   # [B] int32
        h = self._embed(params, tokens)
        for lp, lc, is_global in zip(params["layers"], cache["layers"],
                                     self._layer_flags()):
            h = self._decode_block(_cast(lp, torch.bfloat16), lc, h, pos,
                                   is_global)
        logits = self._logits(params, h)[:, 0]
        return logits, dict(cache, len=pos + 1)

    def _decode_block(self, lp, lc, h: torch.Tensor, pos: torch.Tensor,
                      is_global: bool) -> torch.Tensor:
        cfg = self.cfg
        if cfg.rwkv:
            h, state = self._rwkv_block(lp, h, lc)
            for name, x in state.items():
                lc[name].copy_(x)
            return h
        rs = cfg.residual_scale
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        b = x.shape[0]
        q, k, v = attn_mod.project_qkv(cfg, lp["attn"], x,
                                       positions=pos[:, None])
        cap = lc["k"].shape[1]
        slot = (torch.clamp(pos, max=cap - 1) if is_global
                else pos % cap).long()
        rows = torch.arange(b, device=x.device)
        lc["k"][rows, slot] = k[:, 0].to(lc["k"].dtype)
        lc["v"][rows, slot] = v[:, 0].to(lc["v"].dtype)
        valid_len = torch.clamp(pos + 1, max=cap)
        out = attn_mod.decode_attention(cfg, q, lc["k"], lc["v"], valid_len)
        attn_out = out.reshape(b, 1, cfg.q_dim) @ lp["attn"]["wo"]
        if cfg.hybrid:
            ssm_out, state = ssm_mod.ssm_apply(
                cfg, lp["ssm"], x, {"conv": lc["conv"], "ssd": lc["ssd"]})
            h = h + rs * self._fuse(lp, attn_out, ssm_out)
            for name, s in state.items():
                lc[name].copy_(s)
        else:
            h = h + rs * attn_out
        y = mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                      cfg.act)
        return h + rs * y


def build_model(cfg: ModelConfig, device: Any = None,
                param_dtype: torch.dtype = torch.float32) -> LanguageModel:
    """A ``LanguageModel`` for ``cfg``; raises ``NotImplementedError`` for
    a family or option the port does not carry yet."""
    return LanguageModel(cfg, device=device, param_dtype=param_dtype)
