from repro_torch.config.core import (
    LSTMAE_SHAPES,
    LSTMAEConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
)
from repro_torch.config.registry import REGISTRY, get_config, list_archs, reduced_config

__all__ = [
    "LSTMAE_SHAPES",
    "LSTMAEConfig",
    "ModelConfig",
    "MoEConfig",
    "REGISTRY",
    "RWKVConfig",
    "SSMConfig",
    "ShapeConfig",
    "TrainConfig",
    "get_config",
    "list_archs",
    "reduced_config",
]
