"""olmo-1b — dense, non-parametric LayerNorm.

[arXiv:2402.00838; hf]
16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.config.core import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="transformer",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    norm="nonparametric_ln",
    activation="swiglu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        norm="nonparametric_ln",
        activation="swiglu",
        tie_embeddings=True,
    )
