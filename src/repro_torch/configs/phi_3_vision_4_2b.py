"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.  The CLIP image
tower is a stub: the caller passes precomputed patch embeddings
(``image_embeds``, 576 tokens at d_model), prepended to the text tokens.
"""
from repro_torch.config.core import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="transformer",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    norm="rmsnorm",
    activation="swiglu",
    frontend="vision_stub",
    vision_patches=576,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-reduced",
        family="transformer",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        norm="rmsnorm",
        activation="swiglu",
        frontend="vision_stub",
        vision_patches=8,
    )
