"""rwkv6-7b — Finch: attention-free, data-dependent decay.

[arXiv:2404.05892; hf]
32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.  Sub-quadratic: the
long_500k decode shape runs for this architecture (O(1) state per token).
"""
from repro_torch.config.core import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv6",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # d_model / rwkv.head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65_536,
    norm="layernorm",
    activation="relu_sq",  # RWKV channel-mix uses squared ReLU
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-reduced",
        family="rwkv6",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=224,
        vocab_size=512,
        norm="layernorm",
        activation="relu_sq",
        rwkv=RWKVConfig(head_dim=16, decay_lora=8),
        subquadratic=True,
    )
