"""jamba-v0.1-52b — hybrid Mamba + attention (1:7), MoE 16e top-2.

[arXiv:2403.19887; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Attention on one
layer in eight (offset 4, the middle of each Jamba block); MoE on every
second layer.  Sub-quadratic overall: long_500k runs (only 4 attention
layers carry a KV cache).
"""
from repro_torch.config.core import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="jamba",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65_536,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    attn_offset=4,
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-reduced",
        family="jamba",
        num_layers=8,          # one full Jamba period (7 mamba + 1 attn)
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        norm="rmsnorm",
        activation="swiglu",
        moe=MoEConfig(num_experts=4, top_k=2, every=2),
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
        attn_every=8,
        attn_offset=4,
        subquadratic=True,
    )
