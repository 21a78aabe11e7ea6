"""Assigned architecture configs (--arch <id>): the port's copy of
``repro.configs``."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeSpec,
    input_specs,
    supported_shapes,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS,
    get_config,
    reduced_config,
)
