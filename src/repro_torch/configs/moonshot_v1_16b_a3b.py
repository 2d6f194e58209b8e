"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.

Not Moonlight's architecture, though it cites Moonlight's page: 48
multi-head attention layers, every one MoE, softmax routing with a capacity
factor of 1.25 (which drops tokens over capacity), no shared experts and no
leading dense layer.  Moonlight-16B-A3B as published (27 layers of latent
attention, a dense first layer, sigmoid routing with a correction bias, 2
shared experts, dropless) is ``moonlight-16b-a3b``
(``configs/moonlight_16b_a3b.py``).  These values stay: they are held field
for field to the reference's registry.
"""
from repro_torch.config.core import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="transformer",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(num_experts=64, top_k=6, every=1),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=48,
        vocab_size=512,
        norm="rmsnorm",
        activation="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, every=1),
    )
