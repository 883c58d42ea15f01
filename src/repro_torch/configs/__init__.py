from repro_torch.configs.base import (
    INPUT_SHAPES,
    INPUT_SHAPES_BY_NAME,
    InputShape,
    ModelConfig,
)
from repro_torch.configs.registry import (
    ARCHITECTURES,
    applicable_pairs,
    get_arch,
    get_shape,
    shape_applicable,
)

__all__ = [
    "INPUT_SHAPES",
    "INPUT_SHAPES_BY_NAME",
    "InputShape",
    "ModelConfig",
    "ARCHITECTURES",
    "applicable_pairs",
    "get_arch",
    "get_shape",
    "shape_applicable",
]
