"""Per-architecture configs (plain data, copied from the JAX package)."""

from .base import (SHAPES, ModelConfig, ShapeConfig, get_config, list_archs,
                   reduced_config)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "list_archs", "reduced_config"]
