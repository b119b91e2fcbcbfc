"""Gemma-2 2B — alternating local/global attention + logit softcaps
[arXiv:2408.00118].

26L, d_model=2304, 8H (GQA kv=4, head 256), d_ff=9216, vocab=256000.
Even layers: sliding window 4096; odd layers: global.  Attention softcap 50,
final-logit softcap 30, GeGLU MLP.  Global layers are full attention =>
long_500k skipped (DESIGN.md §3).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256000,
    attention="local_global",
    window_size=4096,
    global_every=2,            # layer i is global iff i % 2 == 1
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    embed_scale=2304.0 ** 0.5,
    notes="local(4096)/global alternation; attn softcap 50, final 30; GeGLU",
)
