"""LM assembly (the JAX package's ``models/transformer.py``): every family
of ``configs`` behind one API — dense GQA (with gemma2's local/global
alternation, soft caps, QK-norm, biases), mixture of experts, RWKV-6,
Hymba (parallel attention and SSM heads), the encoder-decoder
(bidirectional encoder, cross-attention decoder) and the vision-patch
frontend.

``LanguageModel(cfg, device)`` exposes:

- ``param_template() / init_params(generator)``: the parameters as a nested
  dict, with ``"layers"`` (and the encoder-decoder's ``"enc_layers"`` and
  ``"cross_layers"``) a list of per-layer dicts (the JAX package stacks
  them on a leading ``[L, ...]`` axis; ``models.convert`` carries them
  across);
- ``prefill(params, tokens, max_len, patch_embeds=None, src_embeds=None)``:
  full-sequence forward returning the last position's logits and a decode
  cache of capacity ``max_len``; ``patch_embeds`` [B,P,D] (pixtral) go
  before the token embeddings, ``src_embeds`` [B,T,D] (seamless) feed the
  encoder;
- ``decode_step(params, cache, tokens)``: one token for every batch row;
- ``cache_specs(batch, max_len)``: shapes and dtypes of the decode cache;
- ``abstract_params()``, ``param_logical_axes()`` and
  ``input_specs(shape)``: the parameters and a cell's inputs as ``meta``
  tensors, and each parameter's logical axes (the dry-run's and the
  sharding rules' view; ``device="meta"`` builds a model that runs on
  them);
- ``train_loss(params, batch)``: next-token cross-entropy of a batch dict
  (``tokens`` [B,S], and ``patch_embeds`` or ``src_embeds`` where the
  family takes them), differentiable by ``torch.autograd``; with
  ``remat=True`` each decoder and encoder layer's body is recomputed in the
  backward (``torch.utils.checkpoint``), its bfloat16 parameter casts kept
  outside, as the JAX package's ``jax.checkpoint`` does;
- ``_embed_inputs``, ``_decoder_stack`` and ``_logits``: the pieces of a
  full forward, under the JAX package's names (``serve.speculative``
  verifies drafts through them).

Mixed precision follows the JAX package: parameters are kept in
``param_dtype`` (float32 by default), each layer computes in bfloat16, the
KV cache is bfloat16 (or int8 with per-token, per-KV-head float32 scales:
``kv_cache_dtype=torch.int8``), logits are float32.  Like the JAX prefill,
the residual stream goes back to bfloat16 after every layer; like the JAX
decode, it does not (an RWKV layer's float32 output then carries on).
Attention, the WKV6 recurrence and the SSD scan go through the kernel
wrappers (``models.attention``, ``models.rwkv6``, ``models.ssm``):
hand-written CUDA kernels on the card, their plain versions on the CPU.
Under a gradient attention goes through the flash VJP
(``attention.FlashAttention``) and the scans through ``rwkv6.WKV6Scan``
and ``ssm.SSDScan``: the kernels forward, the plain chunked forms'
gradients backward, so every family trains on the card.
The embedding's gradient is a stable-sort segment sum
(``relational.ops.segment_sum``), not the atomic ``index_put_`` of
indexing's backward, so a train step on the card is bitwise repeatable.

The decode cache is heterogeneous per layer, as in the JAX package: k/v
buffers of capacity ``max_len`` for global attention layers, ring buffers
of ``window`` slots (slot = position % window) for sliding-window layers
(Hymba's and gemma2's local layers), the SSM's conv and SSD states beside
them for Hymba, the token shifts and WKV state for RWKV-6, and the
encoder's output for the encoder-decoder (its cross-attention K/V are
projected from it again at every step, as in JAX).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, ShapeConfig
from ..relational.ops import segment_sum
from ..relational.table import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from . import ssm as ssm_mod
from .layers import abstract_params, dense_init, init_params, mlp_apply, \
    mlp_params, param_axes, rms_norm, softcap

__all__ = ["LanguageModel", "build_model", "quantize_kv"]

_NEG_INF = -1e30
_KV_DTYPES = (torch.bfloat16, torch.int8)


def _cast(tree, dtype: torch.dtype):
    """Float leaves of a (nested dict) parameter tree in ``dtype``; a leaf
    already in it is returned as is."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] -> (int8 values, float32 scales [...]), computed in x's
    dtype as the JAX package does: scale = max(|x|) over the head dim,
    clamped to at least 1e-6, / 127; values round(x / scale) (half to even)
    clipped to +-127."""
    sc = torch.clamp(x.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(x / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc.float()


class _EmbeddingLookup(torch.autograd.Function):
    """``table[ids]`` whose backward sums each id's rows in the order they
    occur (stable sort, then a segment sum), deterministic on the card."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        flat = grad.reshape(-1, grad.shape[-1])
        return segment_sum(flat, ids.reshape(-1), ctx.rows), None


def _dequantize_kv(q: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """int8 cache and its scales -> bfloat16 (the JAX decode's
    ``q.astype(bf16) * scale.astype(bf16)``)."""
    return q.to(torch.bfloat16) * sc[..., None].to(torch.bfloat16)


class LanguageModel:
    """LM of any family in ``configs`` on one device.

    ``device=None`` means the card and raises without one; pass
    ``device="cpu"`` to run on the CPU.  ``kv_cache_dtype`` is
    ``torch.bfloat16`` or ``torch.int8``.  ``remat`` recomputes each layer
    in the backward of ``train_loss`` (it changes nothing without a
    gradient).  ``moe_counts``, when set to a dict, gains the device tensors
    ``routed`` and ``dropped`` (the (token, expert) pairs routed and
    dropped by capacity) over the MoE layers the model runs; under remat
    a layer's pairs count twice (its forward runs again)."""

    def __init__(self, cfg: ModelConfig, device: Any = None,
                 param_dtype: torch.dtype = torch.float32,
                 kv_cache_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False):
        if kv_cache_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_cache_dtype {kv_cache_dtype}: the KV cache "
                             f"is one of {_KV_DTYPES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = param_dtype
        self.kv_cache_dtype = kv_cache_dtype
        self.remat = remat
        self.moe_counts: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------ params
    def _layer_template(self) -> Dict:
        cfg = self.cfg
        d = cfg.d_model
        layer = {"ln1": dense_init((d, None), init="zeros"),
                 "ln2": dense_init((d, None), init="zeros")}
        if cfg.rwkv:
            layer.update({f"tm_{k}": v for k, v in
                          rwkv_mod.rwkv_params(cfg).items()})
            return layer
        layer["attn"] = attn_mod.attention_params(cfg)
        if cfg.hybrid:
            layer["ssm"] = ssm_mod.ssm_params(cfg)
            layer["fuse_na"] = dense_init((d, None), init="zeros")
            layer["fuse_ns"] = dense_init((d, None), init="zeros")
            layer["beta_a"] = dense_init((d, None), init="ones")
            layer["beta_s"] = dense_init((d, None), init="ones")
        if cfg.n_experts > 0:
            layer["moe"] = moe_mod.moe_params(cfg)
        else:
            layer["mlp"] = mlp_params(d, cfg.d_ff, cfg.act)
        return layer

    def _encoder_layer_template(self) -> Dict:
        cfg = self.cfg
        d = cfg.d_model
        return {"ln1": dense_init((d, None), init="zeros"),
                "ln2": dense_init((d, None), init="zeros"),
                "attn": attn_mod.attention_params(cfg),
                "mlp": mlp_params(d, cfg.d_ff, cfg.act)}

    def _decoder_cross_template(self) -> Dict:
        return {"ln_cross": dense_init((self.cfg.d_model, None), init="zeros"),
                "cross": attn_mod.attention_params(self.cfg)}

    def param_template(self) -> Dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_padded
        tpl: Dict[str, Any] = {
            "embed": dense_init((v, "vocab"), (d, "embed"), scale=0.02),
            "final_norm": dense_init((d, None), init="zeros"),
            "layers": [self._layer_template() for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            tpl["lm_head"] = dense_init((d, "embed"), (v, "vocab"))
        if cfg.is_encdec:
            tpl["enc_layers"] = [self._encoder_layer_template()
                                 for _ in range(cfg.n_encoder_layers)]
            tpl["enc_norm"] = dense_init((d, None), init="zeros")
            tpl["cross_layers"] = [self._decoder_cross_template()
                                   for _ in range(cfg.n_layers)]
        return tpl

    def init_params(self, generator: torch.Generator) -> Dict:
        """Random parameters under the JAX package's init rule, drawn from
        ``generator`` and placed on the model's device."""
        return init_params(self.param_template(), generator,
                           self.param_dtype, self.device)

    def abstract_params(self) -> Dict:
        """The parameters as ``meta`` tensors in ``param_dtype``: shapes and
        dtypes at full size, no storage (the dry-run's)."""
        return abstract_params(self.param_template(), self.param_dtype)

    def param_logical_axes(self) -> Dict:
        """Each parameter's logical axes, in the parameters' structure (a
        per-layer leaf has the JAX package's stacked leaf's axes without
        the leading ``layers``)."""
        return param_axes(self.param_template())

    # --------------------------------------------------------------- embedding
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> h [B,S,D] bfloat16 (scaled in the param dtype)."""
        ids = tokens.to(self.device, torch.long)
        table = params["embed"]
        h = _EmbeddingLookup.apply(table, ids) if table.requires_grad \
            and torch.is_grad_enabled() else table[ids]
        return (h * self.cfg.embed_scale).to(torch.bfloat16)

    def _embed_inputs(self, params, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, int]:
        """-> (h [B,P+S,D] bfloat16, P): the patch embeddings, where given
        (pixtral), go before the token embeddings."""
        h = self._embed(params, tokens)
        if patch_embeds is None:
            return h, 0
        if self.cfg.frontend != "vision_patches":
            raise ValueError(f"{self.cfg.name} takes no patch embeddings "
                             f"(frontend {self.cfg.frontend!r})")
        patches = patch_embeds.to(self.device, torch.bfloat16)
        return torch.cat([patches, h], dim=1), patch_embeds.shape[1]

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
        last ``window_size`` positions (False): gemma2's layer i is global
        iff i % global_every == global_every - 1, Hymba's if listed."""
        cfg = self.cfg
        if cfg.attention == "local_global" and cfg.global_every:
            return [i % cfg.global_every == cfg.global_every - 1
                    for i in range(cfg.n_layers)]
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

    def _mlp_or_moe(self, lp, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.n_experts > 0:
            return moe_mod.moe_apply(cfg, lp["moe"], x,
                                     counts=self.moe_counts)
        return mlp_apply(lp["mlp"], x, cfg.act)

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

    def _block_seq(self, lp, is_global: bool, h: torch.Tensor,
                   cp: Optional[Dict] = None,
                   enc_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence block (prefill).  Returns (h, this layer's cache
        entries: k/v, plus the SSM or RWKV states).  For the
        encoder-decoder, ``cp``/``enc_out`` put cross-attention between
        self-attention and the MLP."""
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
        if cp is not None:
            h = self._cross_block(cp, h, enc_out)
        y = self._mlp_or_moe(lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
        return h + rs * y, cache

    def _cross_block(self, cp, h: torch.Tensor, enc_out: torch.Tensor,
                     decode: bool = False) -> torch.Tensor:
        """Cross-attention over the encoder's output: queries without RoPE,
        K/V projected from ``enc_out``; the flash kernel non-causal with
        S != T in prefill, the decode kernel over the whole encoder length
        in decode."""
        cfg = self.cfg
        x = rms_norm(h, cp["ln_cross"], cfg.norm_eps)
        q, _, _ = attn_mod.project_qkv(cfg, cp["cross"], x, use_rope=False)
        b, t, _ = enc_out.shape
        k = (enc_out @ cp["cross"]["wk"].to(enc_out.dtype)).reshape(
            b, t, cfg.n_kv_heads, cfg.d_head)
        v = (enc_out @ cp["cross"]["wv"].to(enc_out.dtype)).reshape(
            b, t, cfg.n_kv_heads, cfg.d_head)
        if decode:
            out = attn_mod.decode_attention(
                cfg, q, k, v, torch.full((b,), t, dtype=torch.int32,
                                         device=h.device))
        else:
            out = attn_mod.full_attention(cfg, q, k, v, mask_kind="cross")
        bb, s = out.shape[:2]
        return h + out.reshape(bb, s, cfg.q_dim) @ cp["cross"]["wo"]

    def _decoder_stack(self, params, h: torch.Tensor,
                       collect_cache: bool = False,
                       enc_out: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
        """Every decoder layer over the full sequence -> (h bfloat16, the
        per-layer prefill cache entries if ``collect_cache``, else None)."""
        cross = params.get("cross_layers") if self.cfg.is_encdec else None
        caches = []
        for i, (lp, is_global) in enumerate(zip(params["layers"],
                                                self._layer_flags())):
            cp = _cast(cross[i], torch.bfloat16) if cross else None
            h, c = self._layer(self._block_seq, _cast(lp, torch.bfloat16),
                               is_global, h, cp=cp, enc_out=enc_out)
            h = h.to(torch.bfloat16)        # the JAX layer scan's carry
            if collect_cache:
                caches.append(c)
        return h, caches if collect_cache else None

    def _encoder_stack(self, params, src: torch.Tensor) -> torch.Tensor:
        """src [B,T,D] -> the encoder's output [B,T,D] bfloat16:
        bidirectional self-attention with RoPE, then the MLP, bfloat16
        between layers, then ``enc_norm``."""
        h = src.to(self.device, torch.bfloat16)
        for lp in params["enc_layers"]:
            h = self._layer(self._encoder_block, _cast(lp, torch.bfloat16),
                            h).to(torch.bfloat16)
        return rms_norm(h, params["enc_norm"], self.cfg.norm_eps)

    def _encoder_block(self, lp, h: torch.Tensor) -> torch.Tensor:
        """One bidirectional encoder layer (bfloat16 parameters)."""
        cfg = self.cfg
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, lp["attn"], x)
        out = attn_mod.full_attention(cfg, q, k, v, mask_kind="bidir")
        b, s = out.shape[:2]
        h = h + out.reshape(b, s, cfg.q_dim) @ lp["attn"]["wo"]
        return h + mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                             cfg.act)

    def _layer(self, fn, *args, **kw):
        """``fn(*args, **kw)``, one layer's body; under a gradient with
        ``remat`` it is checkpointed, so the backward runs it again (its
        kernels launch twice) instead of keeping its activations."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return fn(*args, **kw)

    # ------------------------------------------------------------------ train
    def train_loss(self, params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean next-token negative log-likelihood (float32 scalar) of
        ``batch["tokens"]`` [B,S]: the encoder first where the family has
        one (``batch["src_embeds"]`` [B,T,D]), the patch prefix
        (``batch["patch_embeds"]`` [B,P,D], pixtral) dropped before the
        head, log-softmax in float32 over ``logits[:, :-1]`` against
        ``tokens[:, 1:]``."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device, torch.long)
        enc_out = self._encoder_stack(params, batch["src_embeds"]) \
            if cfg.is_encdec else None
        patches = batch.get("patch_embeds") \
            if cfg.frontend == "vision_patches" else None
        h, n_prefix = self._embed_inputs(params, tokens, patches)
        h, _ = self._decoder_stack(params, h, enc_out=enc_out)
        logits = self._logits(params, h[:, n_prefix:])
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        ll = logp.gather(-1, tokens[:, 1:, None])[..., 0]
        return -ll.mean()

    # ---------------------------------------------------------------- prefill
    def prefill(self, params, tokens: torch.Tensor,
                max_len: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                src_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B,S] -> (last-position logits [B,V_padded] float32, decode
        cache of capacity ``max_len`` (default P + S + 64)).
        ``patch_embeds`` [B,P,D] go before the tokens (pixtral);
        ``src_embeds`` [B,T,D] are the encoder's input (seamless, where
        they are required)."""
        cfg = self.cfg
        enc_out = None
        if cfg.is_encdec:
            if src_embeds is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder prefill "
                                 f"needs src_embeds")
            enc_out = self._encoder_stack(params, src_embeds)
        elif src_embeds is not None:
            raise ValueError(f"{cfg.name} has no encoder: src_embeds given")
        h, _ = self._embed_inputs(params, tokens, patch_embeds)
        seq_len = h.shape[1]
        max_len = max_len or seq_len + 64
        if seq_len > max_len:
            raise ValueError(f"prefill: prompt of {seq_len} tokens exceeds "
                             f"the cache capacity max_len={max_len}")
        h, caches = self._decoder_stack(params, h, collect_cache=True,
                                        enc_out=enc_out)
        logits = self._logits(params, h[:, -1:])
        cache = {"len": torch.full((h.shape[0],), seq_len, dtype=torch.int32,
                                   device=self.device),
                 "layers": self._prefill_caches_to_decode(
                     caches, h.shape[0], seq_len, max_len)}
        if enc_out is not None:
            cache["enc_out"] = enc_out
        return logits[:, 0], cache

    def _prefill_caches_to_decode(self, caches: List[Dict], batch: int,
                                  seq_len: int, max_len: int) -> List[Dict]:
        """Per-layer prefill entries -> the decode cache of
        ``cache_specs``: k/v [B,S,Kv,hd] into full-capacity buffers (zero
        past the prompt) or, for sliding-window layers, ring buffers holding
        the last ``window`` positions at slot = position % window, then (an
        int8 cache) the whole buffer quantized in float32 with its scales;
        states copied in the spec's dtype."""
        out = []
        for entries, spec in zip(caches,
                                 self.cache_specs(batch, max_len)["layers"]):
            layer = {}
            for name, (shape, dtype) in spec.items():
                if name in ("k_scale", "v_scale"):
                    continue
                x = entries[name]
                if name not in ("k", "v"):
                    layer[name] = x.to(dtype, copy=True)
                    continue
                buf = torch.zeros(shape, dtype=torch.bfloat16,
                                  device=self.device)
                take = min(shape[1], seq_len)
                slots = torch.arange(seq_len - take, seq_len,
                                     device=self.device) % shape[1]
                buf[:, slots] = x[:, seq_len - take:].to(torch.bfloat16)
                if dtype == torch.int8:
                    layer[name], layer[f"{name}_scale"] = \
                        quantize_kv(buf.float())
                else:
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
            if self.kv_cache_dtype == torch.int8:
                scale = ((batch, cap, cfg.n_kv_heads), torch.float32)
                entry.update(k_scale=scale, v_scale=scale)
            if cfg.hybrid:
                entry.update(ssm_mod.ssm_state_specs(cfg, batch))
            layers.append(entry)
        spec = {"len": ((batch,), torch.int32), "layers": layers}
        if cfg.is_encdec:
            enc_len = max(1, int(max_len * cfg.encoder_len_ratio))
            spec["enc_out"] = ((batch, enc_len, cfg.d_model), torch.bfloat16)
        return spec

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens [B,1] -> (logits [B,V_padded] float32, cache advanced one
        position).  Unlike the JAX package, which returns new buffers, the
        new token's k/v (and int8 scales) and every layer's new states are
        written into the cache's buffers in place (at full width a copy
        would move the whole cache every step); the buffers keep their
        dtypes."""
        pos = cache["len"]                                   # [B] int32
        h = self._embed(params, tokens)
        cross = params.get("cross_layers") if self.cfg.is_encdec else None
        for i, (lp, lc, is_global) in enumerate(zip(
                params["layers"], cache["layers"], self._layer_flags())):
            cp = _cast(cross[i], torch.bfloat16) if cross else None
            h = self._decode_block(_cast(lp, torch.bfloat16), lc, h, pos,
                                   is_global, cp=cp,
                                   enc_out=cache.get("enc_out"))
        logits = self._logits(params, h)[:, 0]
        return logits, dict(cache, len=pos + 1)

    def _decode_block(self, lp, lc, h: torch.Tensor, pos: torch.Tensor,
                      is_global: bool, cp: Optional[Dict] = None,
                      enc_out: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
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
        if self.kv_cache_dtype == torch.int8:
            # quantized in the new token's dtype (bfloat16), as in JAX
            for name, val in (("k", k), ("v", v)):
                qv, sc = quantize_kv(val[:, 0])
                lc[name][rows, slot] = qv
                lc[f"{name}_scale"][rows, slot] = sc
            k_att = _dequantize_kv(lc["k"], lc["k_scale"])
            v_att = _dequantize_kv(lc["v"], lc["v_scale"])
        else:
            lc["k"][rows, slot] = k[:, 0].to(lc["k"].dtype)
            lc["v"][rows, slot] = v[:, 0].to(lc["v"].dtype)
            k_att, v_att = lc["k"], lc["v"]
        valid_len = torch.clamp(pos + 1, max=cap)
        out = attn_mod.decode_attention(cfg, q, k_att, v_att, valid_len)
        attn_out = out.reshape(b, 1, cfg.q_dim) @ lp["attn"]["wo"]
        if cfg.hybrid:
            ssm_out, state = ssm_mod.ssm_apply(
                cfg, lp["ssm"], x, {"conv": lc["conv"], "ssd": lc["ssd"]})
            h = h + rs * self._fuse(lp, attn_out, ssm_out)
            for name, s in state.items():
                lc[name].copy_(s)
        else:
            h = h + rs * attn_out
        if cp is not None:
            h = self._cross_block(cp, h, enc_out, decode=True)
        y = self._mlp_or_moe(lp, rms_norm(h, lp["ln2"], cfg.norm_eps))
        return h + rs * y


    # ------------------------------------------------------------ input specs
    def input_specs(self, shape: ShapeConfig) -> Dict:
        """``meta`` tensors standing in for every input of a cell, with the
        JAX package's shapes and dtypes: a train or prefill batch
        (``tokens``, and ``patch_embeds`` or ``src_embeds`` where the family
        takes them), or a decode step's ``tokens`` [B,1] and ``cache`` at
        context length ``shape.seq_len``."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            if cfg.frontend == "vision_patches":
                npatch = cfg.n_frontend_tokens
                return {"tokens": meta((b, s - npatch), torch.int32),
                        "patch_embeds": meta((b, npatch, cfg.d_model),
                                             torch.bfloat16)}
            batch = {"tokens": meta((b, s), torch.int32)}
            if cfg.is_encdec:
                src = max(1, int(s * cfg.encoder_len_ratio))
                batch["src_embeds"] = meta((b, src, cfg.d_model),
                                           torch.bfloat16)
            return batch

        def metas(spec):
            if isinstance(spec, dict):
                return {k: metas(v) for k, v in spec.items()}
            if isinstance(spec, list):
                return [metas(v) for v in spec]
            return meta(*spec)

        return {"tokens": meta((b, 1), torch.int32),
                "cache": metas(self.cache_specs(b, s))}


def build_model(cfg: ModelConfig, device: Any = None,
                param_dtype: torch.dtype = torch.float32,
                kv_cache_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False) -> LanguageModel:
    """A ``LanguageModel`` for ``cfg`` (any of ``configs.list_archs()``)."""
    return LanguageModel(cfg, device=device, param_dtype=param_dtype,
                         kv_cache_dtype=kv_cache_dtype, remat=remat)
