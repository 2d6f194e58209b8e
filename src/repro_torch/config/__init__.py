from repro_torch.config.core import (
    LSTMAE_SHAPES,
    LSTMAEConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.config.registry import REGISTRY, get_config, list_archs, reduced_config

__all__ = [
    "LSTMAE_SHAPES",
    "LSTMAEConfig",
    "ModelConfig",
    "REGISTRY",
    "ShapeConfig",
    "TrainConfig",
    "get_config",
    "list_archs",
    "reduced_config",
]
