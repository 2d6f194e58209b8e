"""dbrx-132b — 16 experts top-4, fine-grained MoE.

[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.config.core import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="transformer",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100_352,
    norm="layernorm",
    activation="swiglu",
    moe=MoEConfig(num_experts=16, top_k=4, every=1),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        norm="layernorm",
        activation="swiglu",
        moe=MoEConfig(num_experts=4, top_k=2, every=1),
    )
