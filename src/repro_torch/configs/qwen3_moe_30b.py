"""Qwen3-30B-A3B — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32H (GQA kv=4, head 128), d_ff=768 per expert,
vocab=151936, MoE 128 experts top-8 (no shared expert), QK-norm.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    attention="full",
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    notes="qwen3 MoE: 128e top-8 normalized router, head_dim 128 "
          "(q_dim 4096 != d_model)",
)
