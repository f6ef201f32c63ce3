"""The side LM stack's model zoo: one config + facade (the dense family so far)."""

from repro_torch.models.config import (
    ALL_SHAPES,
    ARCH_IDS,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    Family,
    ModelConfig,
    MoEConfig,
    PORTED_ARCHS,
    SSMConfig,
    ShapeCell,
    get_config,
    shapes_for,
)
from repro_torch.models.model import Model

__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "Family",
    "ModelConfig",
    "MoEConfig",
    "PORTED_ARCHS",
    "SSMConfig",
    "ShapeCell",
    "get_config",
    "shapes_for",
    "Model",
]
