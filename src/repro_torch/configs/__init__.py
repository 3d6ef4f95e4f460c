"""Architecture configs: one module per assigned architecture (a copy of
``repro.configs``, which is pure Python)."""

from repro_torch.configs.base import (ArchConfig, ShapeCell, get_arch,
                                      get_shape, list_archs, register,
                                      SHAPES, applicable_cells)

__all__ = ["ArchConfig", "ShapeCell", "get_arch", "get_shape", "list_archs",
           "register", "SHAPES", "applicable_cells"]
