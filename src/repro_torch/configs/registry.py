"""Architecture registry: ``--arch <id>`` resolution for launchers."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, INPUT_SHAPES_BY_NAME, InputShape, ModelConfig
from repro_torch.configs.granite_3_2b import CONFIG as GRANITE_3_2B
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from repro_torch.configs.h2o_danube_1_8b import CONFIG as H2O_DANUBE_1_8B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from repro_torch.configs.qwen1_5_32b import CONFIG as QWEN1_5_32B
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.llava_next_34b import CONFIG as LLAVA_NEXT_34B
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM

ARCHITECTURES: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        GRANITE_3_2B,
        QWEN3_MOE_30B_A3B,
        H2O_DANUBE_1_8B,
        DEEPSEEK_67B,
        ZAMBA2_1_2B,
        QWEN1_5_32B,
        MAMBA2_130M,
        LLAVA_NEXT_34B,
        DBRX_132B,
        WHISPER_MEDIUM,
    )
}


def get_arch(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}") from None


def get_shape(name: str) -> InputShape:
    try:
        return INPUT_SHAPES_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown input shape {name!r}; available: {[s.name for s in INPUT_SHAPES]}") from None


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """Whether (arch, shape) is runnable.

    long_500k requires sub-quadratic decode (SSM / hybrid / SWA); pure
    full-attention archs skip it (DESIGN.md §Arch-applicability).
    """
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def applicable_pairs():
    for cfg in ARCHITECTURES.values():
        for shape in INPUT_SHAPES:
            yield cfg, shape, shape_applicable(cfg, shape)
