"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892].

24L, d_model=2048, d_ff=7168, vocab=65536.  WKV6 heads of size 64 (32 heads);
time-mix with LoRA-produced data-dependent decay w_t, token-shift lerps,
bonus term u; channel-mix with squared-ReLU.  State is O(1) in sequence
length => runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # wkv heads (head size 64)
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    rwkv=True,
    act="relu_sq",
    sub_quadratic=True,
    notes="Finch: data-dependent decay via LoRA; token-shift; "
          "channel-mix squared ReLU",
)
