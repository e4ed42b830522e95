"""Per-architecture configs (exact public numbers) + the registry."""

from .base import (ARCH_IDS, ArchConfig, MLAConfig, MoEConfig, SSMConfig,
                   get_config, list_configs)  # noqa: F401
from .shapes import SHAPES, ShapeSpec, applicable_shapes  # noqa: F401
