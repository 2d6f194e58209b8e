"""Config system of the port: every architecture is a frozen dataclass.

A copy of the JAX package's ``repro/config/core.py``: the LSTM-AE family,
the LM families' ``ModelConfig`` fields with ``MoEConfig``, ``SSMConfig``
and ``RWKVConfig`` (the port runs every family: the dense and MoE
transformers, RWKV-6, Jamba and Whisper), the LSTM-AE shapes and
``TrainConfig``.  The port imports nothing of that package, so the copy
is held to it field for field by
``tests/test_torch_*.py``.  One difference of wording: the reference's
``LSTMAEConfig`` docstring calls the per-layer hidden sizes
``feature_sizes``; both packages' method is ``layer_sizes``, and the
port's raises ``ValueError`` where the reference asserts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    every: int = 1           # apply MoE on layers where (layer_idx % every == every-1)
    capacity_factor: float = 1.25
    impl: str = "scatter"    # "scatter" (ragged, prod) | "dense" (GShard oracle)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM hyper-params (used by jamba)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64     # rank of the data-dependent decay LoRA
    token_shift: bool = True
    scan_impl: str = "steps"  # "steps" (exact per-step scan) | "chunked"


@dataclass(frozen=True)
class LSTMAEConfig:
    """The paper's LSTM-Autoencoder family: F{X}-D{Y}.

    ``layer_sizes`` holds the per-layer hidden sizes, e.g. F32-D6 =>
    (16, 8, 4, 8, 16, 32) for input feature size 32 (the output of the final
    decoder layer reconstructs the input width).
    """
    input_features: int
    depth: int               # total LSTM layers (half encoder / half decoder)

    def layer_sizes(self) -> tuple[int, ...]:
        """Per-layer hidden sizes, halving to the bottleneck then doubling back."""
        half = self.depth // 2
        enc = [self.input_features // (2 ** (i + 1)) for i in range(half)]
        dec = list(reversed(enc[:-1])) + [self.input_features]
        sizes = tuple(enc + dec)
        if len(sizes) != self.depth or not all(s >= 1 for s in sizes):
            raise ValueError(
                f"depth {self.depth} does not fit F{self.input_features}")
        return sizes

    def layer_input_sizes(self) -> tuple[int, ...]:
        """Input feature dimension LX_i of each LSTM layer."""
        return (self.input_features,) + self.layer_sizes()[:-1]


@dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference ``ModelConfig``.  The port runs every
    family: "lstm_ae", "transformer" (dense, or MoE with ``moe`` set),
    "rwkv6", "jamba" and "whisper"."""
    name: str
    family: str              # transformer | rwkv6 | jamba | whisper | lstm_ae
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"    # rmsnorm | layernorm | nonparametric_ln
    activation: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 10000.0
    max_seq_len: int = 524_288
    tie_embeddings: bool = False
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    lstm_ae: Optional[LSTMAEConfig] = None
    # hybrid interleave: attention on layers where (idx % attn_every == attn_offset)
    attn_every: int = 1
    attn_offset: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq_len: int = 0     # post-conv frame count (stub frontend)
    # modality frontend stub: none | audio_stub | vision_stub
    frontend: str = "none"
    vision_patches: int = 576    # phi-3-vision: 24x24 CLIP patch tokens (stub)
    # sub-quadratic? (controls long_500k applicability)
    subquadratic: bool = False
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # decode layer loop: "scan" (one stacked cache) or "unroll" (a tuple of
    # per-layer caches)
    decode_loop: str = "scan"
    # training only: pins the layer entry's sharding in the reference
    bwd_constrain: bool = False

    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    def is_attn_layer(self, idx: int) -> bool:
        return idx % self.attn_every == self.attn_offset

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return idx % self.moe.every == self.moe.every - 1

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


# LSTM-AE (paper) shapes: streaming anomaly detection over T timesteps.
LSTMAE_SHAPES = tuple(
    ShapeConfig(f"stream_{t}", seq_len=t, global_batch=4096, kind="train")
    for t in (16, 64)
) + (ShapeConfig("serve_64", seq_len=64, global_batch=8192, kind="prefill"),)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    remat: str = "layer"        # none | layer (checkpoint each block)
    loss_chunk: int = 2048      # chunked xent: tokens per logits chunk
    grad_compression: str = "none"  # none | int8_ef
    microbatch: int = 1         # gradient accumulation steps
