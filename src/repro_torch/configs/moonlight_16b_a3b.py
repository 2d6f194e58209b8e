"""moonlight-16b-a3b: Moonshot AI's Moonlight-16B-A3B, a DeepSeek-V3 model.

[hf:moonshotai/Moonlight-16B-A3B/config.json, model_type deepseek_v3]
27 layers, d_model 2048; layer 0 dense (SwiGLU 11,264), layers 1-26 MoE:
64 routed experts of width 1,408, 6 a token, plus 2 shared, sigmoid scores
with a correction bias that only chooses (noaux_tc, one group), the chosen
scores renormalised and scaled by 2.446.  Every layer is MLA without a
query LoRA: 16 heads, queries and keys of 128 + 64 (RoPE), values of 128,
a 512-wide latent plus one 64-wide RoPE key shared by the heads.  RoPE
theta 50,000, RMSNorm eps 1e-5, vocabulary 163,840 untied, context 8,192.

A port-only architecture: the JAX package's registry has no DeepSeek-V3
family.  Weights are bf16, as the published checkpoint's are: at float32
the 15.96 B parameters would take 64 GB of an 80 GB card.
"""
from repro_torch.config.deepseek import DeepSeekV3Config

CONFIG = DeepSeekV3Config(
    name="moonlight-16b-a3b",
    family="deepseek_v3",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11_264,
    vocab_size=163_840,
    head_dim=192,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=50_000.0,
    max_seq_len=8_192,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense_replace=1,
    n_routed_experts=64,
    num_experts_per_tok=6,
    n_shared_experts=2,
    moe_intermediate_size=1408,
    routed_scaling_factor=2.446,
    norm_topk_prob=True,
    rms_norm_eps=1e-5,
)


def reduced() -> DeepSeekV3Config:
    """Every width divided by 16 (heads kept at 16), 16 routed experts with
    6 a token and 2 shared, one dense and eleven MoE layers: the CPU tests'
    size (eleven, so that a fault in the routing weights, which acts a
    little at every MoE layer, shows over bf16's own error)."""
    return DeepSeekV3Config(
        name="moonlight-16b-a3b-reduced",
        family="deepseek_v3",
        num_layers=12,
        d_model=128,
        num_heads=16,
        num_kv_heads=16,
        d_ff=704,
        vocab_size=10_240,
        head_dim=12,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=50_000.0,
        max_seq_len=8_192,
        tie_embeddings=False,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        kv_lora_rank=32,
        qk_nope_head_dim=8,
        qk_rope_head_dim=4,
        v_head_dim=8,
        first_k_dense_replace=1,
        n_routed_experts=16,
        num_experts_per_tok=6,
        n_shared_experts=2,
        moe_intermediate_size=88,
        routed_scaling_factor=2.446,
        norm_topk_prob=True,
        rms_norm_eps=1e-5,
    )
