"""Hymba-1.5B — hybrid parallel attention + Mamba heads [arXiv:2411.13676; hf].

32L, d_model=1600, 25 query heads (GQA kv=5, head 64), d_ff=5504,
vocab=32001, ssm_state=16.  Per the paper: most layers use sliding-window
attention with three full-attention layers (first / middle / last); every
block runs attention heads and SSM heads *in parallel* on the same input and
fuses their (normalized, scaled) outputs.  Sub-quadratic => runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    attention="swa_global",
    window_size=1024,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_expand=2,
    hybrid=True,
    act="silu",
    sub_quadratic=True,
    notes="parallel attn+mamba heads; SWA + 3 global layers; meta tokens "
          "omitted (128 registers would add <0.1% FLOPs)",
)
