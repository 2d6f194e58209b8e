"""Config system of the port: the paper's LSTM-AE family as frozen dataclasses.

A copy of the parts of the JAX package's ``repro/config/core.py`` that the
LSTM-AE slice reads.  The port imports nothing of that package, so the
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
