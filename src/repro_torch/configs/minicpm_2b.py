"""MiniCPM-2B — llama-like dense with WSD schedule + mu-p-style scaling
[arXiv:2404.06395; hf].

40L, d_model=2304, 36H (kv=36, i.e. MHA, head 64), d_ff=5760, vocab=122753.
MiniCPM's signature tricks: depth-scaled residuals (1.4/sqrt(L)), embedding
scale 12, logit scale d/256-divided — and the WSD (warmup-stable-decay) LR
schedule, implemented in ``repro.train.optimizer``.
"""

import math

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab_size=122753,
    attention="full",
    act="silu",
    tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(40),
    embed_scale=12.0,
    logit_scale=256.0 / 2304.0,
    notes="WSD schedule (train.optimizer.wsd_schedule); "
          "depth-scaled residuals",
)
