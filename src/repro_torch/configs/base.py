"""Architecture configuration, a plain-Python copy of the JAX package's
``configs/base.py``: :class:`ModelConfig`, ``get_config(name)``,
``list_archs()`` and ``reduced_config(cfg)`` (the CPU-test variant: same
family, tiny dims), and the cell shapes :class:`ShapeConfig` / ``SHAPES``
(the training launcher builds its own ``ShapeConfig``), and the cells the
dry-run covers: ``cell_skips()`` (with the JAX package's reasons, word for
word) and ``runnable_cells()``.  Every
architecture is a :class:`ModelConfig` in its own module under
``repro_torch.configs``; ``models.transformer.build_model``
decides which of them the port can run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "reduced_config", "kernel_reduced_config", "list_archs",
           "runnable_cells", "cell_skips"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0

    # attention flavor
    attention: str = "full"       # full | local_global | swa_global | none
    window_size: int = 4096
    global_layers: Tuple[int, ...] = ()   # explicit global-attn layer ids
    global_every: int = 0                 # gemma2-style alternation period
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # SSM / recurrent
    ssm_state: int = 0
    ssm_expand: int = 2
    rwkv: bool = False

    # hybrid (parallel attn + ssm heads, Hymba)
    hybrid: bool = False

    # encoder-decoder
    is_encdec: bool = False
    n_encoder_layers: int = 0
    encoder_len_ratio: float = 1.0   # encoder source len = seq_len * ratio

    # multimodal frontend stub
    frontend: str = "none"           # none | vision_patches | audio_frames
    n_frontend_tokens: int = 0

    # misc
    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    residual_scale: float = 1.0      # minicpm depth-scaled residuals
    embed_scale: float = 1.0
    logit_scale: float = 1.0
    sub_quadratic: bool = False      # eligible for long_500k
    notes: str = ""

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab dim always
        divides the TP axis (Megatron-style padding; padded logit positions
        are masked to -inf before the softmax)."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = 0
        if self.attention != "none":
            per_layer += d * self.q_dim + 2 * d * self.kv_dim \
                + self.q_dim * d
        if self.rwkv:
            per_layer += 4 * d * d + d * f + f * d   # time-mix + channel-mix
        elif self.n_experts > 0:
            per_layer += self.n_experts * 3 * d * f + d * self.n_experts
            per_layer += self.n_shared_experts * 3 * d * f
        else:
            per_layer += 3 * d * f
        if self.hybrid:
            inner = self.ssm_expand * d
            per_layer += 2 * d * inner + inner * d \
                + inner * (2 * self.ssm_state)
        total = self.n_layers * per_layer
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            enc_layer = d * self.q_dim + 2 * d * self.kv_dim \
                + self.q_dim * d + 3 * d * f
            total += self.n_encoder_layers * enc_layer
            total += self.n_layers * (d * self.q_dim + 2 * d * self.kv_dim
                                      + self.q_dim * d)  # cross-attn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE-aware), for 6·N_active·D."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = dataclasses.replace(self, n_experts=0,
                                         n_shared_experts=0)
        base = dense_like.param_count() - self.n_layers * 3 * d * f
        active = (self.experts_per_token + self.n_shared_experts) * 3 * d * f
        return base + self.n_layers * active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

_ARCH_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minicpm-2b": "minicpm_2b",
    "qwen2.5-14b": "qwen2p5_14b",
    "gemma2-2b": "gemma2_2b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
    "pixtral-12b": "pixtral_12b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    n_kv = min(cfg.n_kv_heads, 2)
    n_heads = max(2, min(4, cfg.n_heads))
    # keep q/kv grouping valid
    if n_heads % n_kv != 0:
        n_kv = 1
    return dataclasses.replace(
        cfg,
        n_layers=2 if not cfg.is_encdec else 2,
        n_encoder_layers=2 if cfg.is_encdec else 0,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=96 if cfg.n_experts == 0 else 32,
        vocab_size=251,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        window_size=min(cfg.window_size, 8),
        global_layers=(0,) if cfg.global_layers else (),
        ssm_state=min(cfg.ssm_state, 4) if cfg.ssm_state else 0,
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
    )


def kernel_reduced_config(cfg: ModelConfig) -> ModelConfig:
    """``reduced_config`` at the kernels' head size, the port's launchers'
    reduced config: ``d_head`` 64 (the attention kernels' smallest, the
    WKV kernel's only one; the JAX package's reduced configs use 16) and,
    for RWKV-6, ``n_heads = d_model // 64``."""
    cfg = dataclasses.replace(reduced_config(cfg), d_head=64)
    if cfg.rwkv:
        cfg = dataclasses.replace(cfg, n_heads=cfg.d_model // 64,
                                  n_kv_heads=cfg.d_model // 64)
    return cfg


def cell_skips() -> Dict[Tuple[str, str], str]:
    """(arch, shape) -> reason, for the 8 documented skips."""
    skips: Dict[Tuple[str, str], str] = {}
    for arch in list_archs():
        cfg = get_config(arch)
        if not cfg.sub_quadratic:
            skips[(arch, "long_500k")] = (
                "pure full-attention architecture: 512k-token single-step "
                "decode requires sub-quadratic sequence mixing "
                "(DESIGN.md §3)")
    return skips


def runnable_cells() -> List[Tuple[str, str]]:
    skips = cell_skips()
    cells = []
    for arch in list_archs():
        for shape in SHAPES:
            if (arch, shape) not in skips:
                cells.append((arch, shape))
    return cells
