"""The paper's contribution: temporal-parallel dataflow LSTM-AE execution.

- lstm.py       LSTM cell / layer / autoencoder (Fig. 1, Section 2)
- temporal.py   wavefront + pipelined executors (Section 3.1-3.2)
- balancing.py  reuse-factor equations (2)-(8) + stage partition (3.3)
- latency.py    Eq (1) latency/energy model reproducing Tables 1-3
- anomaly.py    reconstruction-error detection (the application)
"""
from repro_torch.core.lstm import (
    init_lstm_ae,
    init_lstm_cell,
    lstm_ae_reconstruction_error,
    lstm_ae_sequential,
    lstm_cell,
    lstm_layer,
    pwl_sigmoid,
    pwl_tanh,
    stacked_cell_params,
)
from repro_torch.core.temporal import (
    build_stage_params,
    pipelined_forward,
    schedule_table,
    wavefront_forward,
)

__all__ = [
    "build_stage_params",
    "init_lstm_ae",
    "init_lstm_cell",
    "lstm_ae_reconstruction_error",
    "lstm_ae_sequential",
    "lstm_cell",
    "lstm_layer",
    "pipelined_forward",
    "pwl_sigmoid",
    "pwl_tanh",
    "schedule_table",
    "stacked_cell_params",
    "wavefront_forward",
]
