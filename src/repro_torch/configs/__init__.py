"""Per-architecture configs (plain data, copied from the JAX package)."""

from .base import (SHAPES, ModelConfig, ShapeConfig, cell_skips, get_config,
                   kernel_reduced_config, list_archs, reduced_config,
                   runnable_cells)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "list_archs", "reduced_config", "kernel_reduced_config",
           "cell_skips", "runnable_cells"]
