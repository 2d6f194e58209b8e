"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA.

[arXiv:2412.08905; hf]
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.config.core import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="transformer",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    norm="rmsnorm",
    activation="swiglu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b-reduced",
        family="transformer",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=True,
    )
