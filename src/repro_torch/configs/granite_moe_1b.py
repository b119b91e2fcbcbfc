"""Granite-3.0-1B-A400M — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16H (GQA kv=8, head 64), d_ff=512 per expert,
vocab=49155, MoE 32 experts top-8.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    attention="full",
    act="silu",
    tie_embeddings=True,
    notes="granite MoE: 32e top-8, gated SwiGLU experts, tied embeddings",
)
