"""Config system of the port: the paper's LSTM-AE family as frozen dataclasses.

A copy of the parts of the JAX package's ``repro/config/core.py`` that the
LSTM-AE slice reads, and its ``TrainConfig``.  The port imports nothing of that package, so the
copy is held to it by ``tests/test_torch_*.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


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
    """The fields of the reference ``ModelConfig`` that the LSTM-AE path reads."""
    name: str
    family: str              # only "lstm_ae" is served by the port so far
    num_layers: int = 0
    lstm_ae: Optional[LSTMAEConfig] = None

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
