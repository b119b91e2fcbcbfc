"""SeamlessM4T-large-v2 — encoder-decoder multimodal backbone
[arXiv:2308.11596].

24L encoder + 24L decoder, d_model=1024, 16H (kv=16, head 64), d_ff=8192,
vocab=256206.  The audio frontend (w2v-BERT conformer feature extractor) is a
STUB per assignment: ``input_specs()`` supplies precomputed frame embeddings
(B, S_src, d_model); the backbone here is the text/unit enc-dec transformer.
Encoder source length = seq_len / 4 (the frontend's 4x subsampling),
documented in DESIGN.md.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,              # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab_size=256206,
    attention="full",
    is_encdec=True,
    n_encoder_layers=24,
    encoder_len_ratio=0.25,
    frontend="audio_frames",
    act="relu",
    notes="enc-dec; audio frontend stubbed with precomputed frame embeddings",
)
