"""LM side of the port (inference): every family of ``configs`` — dense
(with gemma2's local/global alternation), mixture of experts, RWKV-6,
Hymba, the encoder-decoder and the vision-patch frontend."""

from .moe import moe_apply, moe_params, moe_reference
from .transformer import LanguageModel, build_model, quantize_kv

__all__ = ["LanguageModel", "build_model", "quantize_kv", "moe_apply",
           "moe_params", "moe_reference"]
