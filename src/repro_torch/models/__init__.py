"""LM side of the port (inference): the dense full-attention family,
RWKV-6 and Hymba."""

from .transformer import LanguageModel, build_model

__all__ = ["LanguageModel", "build_model"]
