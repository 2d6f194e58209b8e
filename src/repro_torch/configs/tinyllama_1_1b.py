"""tinyllama-1.1b — llama2-architecture small model.

[arXiv:2401.02385; hf]
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.config.core import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="transformer",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    norm="rmsnorm",
    activation="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        norm="rmsnorm",
        activation="swiglu",
    )
