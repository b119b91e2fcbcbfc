"""Per-architecture configs (plain data, copied from the JAX package)."""

from .base import ModelConfig, get_config, list_archs, reduced_config

__all__ = ["ModelConfig", "get_config", "list_archs", "reduced_config"]
