"""whisper-large-v3 — encoder-decoder audio model, conv frontend stubbed.

[arXiv:2212.04356; unverified]
32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866.  The mel/conv
frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (1500 frames at d_model).  The 32 layers are
the decoder; the encoder mirrors with 32 layers (whisper-large-v3 layout).
"""
from repro_torch.config.core import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="whisper",
    num_layers=32,          # decoder layers
    encoder_layers=32,
    encoder_seq_len=1500,   # 30 s of audio after the (stubbed) conv stem
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    norm="layernorm",
    activation="gelu",
    qkv_bias=True,
    frontend="audio_stub",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-reduced",
        family="whisper",
        num_layers=2,
        encoder_layers=2,
        encoder_seq_len=12,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        norm="layernorm",
        activation="gelu",
        qkv_bias=True,
        frontend="audio_stub",
    )
