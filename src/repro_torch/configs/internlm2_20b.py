"""internlm2-20b — dense GQA.

[arXiv:2403.17297; hf]
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.config.core import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="transformer",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92_544,
    norm="rmsnorm",
    activation="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-reduced",
        family="transformer",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        norm="rmsnorm",
        activation="swiglu",
    )
