"""Optimiser of the port: AdamW and int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from repro_torch.optim.compression import (
    compress_grads,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)

__all__ = [
    "AdamWState",
    "adamw_update",
    "clip_by_global_norm",
    "compress_grads",
    "dequantize_int8",
    "global_norm",
    "init_error_feedback",
    "init_opt_state",
    "lr_schedule",
    "quantize_int8",
]
