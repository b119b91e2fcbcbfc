"""Pixtral-12B — Mistral-Nemo-style decoder backbone + ViT frontend stub
[hf:mistralai/Pixtral-12B-2409].

40L, d_model=5120, 32H (GQA kv=8, head 128), d_ff=14336, vocab=131072.
The Pixtral-ViT vision tower is a STUB per assignment: ``input_specs()``
supplies 1024 precomputed patch embeddings (B, 1024, d_model) that are
prepended to the text tokens; the decoder attends over the joint sequence.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    attention="full",
    rope_theta=1_000_000.0,
    act="silu",
    frontend="vision_patches",
    n_frontend_tokens=1024,
    notes="mistral-nemo decoder; ViT patches stubbed as precomputed "
          "embeddings prepended to text",
)
