"""LM side of the port: the dense, full-attention family (inference)."""

from .transformer import LanguageModel, build_model

__all__ = ["LanguageModel", "build_model"]
