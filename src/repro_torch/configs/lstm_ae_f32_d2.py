"""LSTM-AE-F32-D2 — 2 layers, 32->16->32 features.

Paper Section 4.1, Table 1: RH_m = 1 on the ZCU104.
"""
from repro_torch.config.core import LSTMAEConfig, ModelConfig

CONFIG = ModelConfig(
    name="lstm-ae-f32-d2",
    family="lstm_ae",
    num_layers=2,
    lstm_ae=LSTMAEConfig(input_features=32, depth=2),
    subquadratic=True,
)


def reduced() -> ModelConfig:
    # Already small; the reduced config is the config itself under a new name.
    return CONFIG.with_overrides(name="lstm-ae-f32-d2-reduced")
