"""Public wrappers around the hand-written kernels.

Counterpart of ``repro/kernels/ops.py``.  The reference picks interpret
mode off the TPU; here the device of the tensors decides: a CPU tensor goes
to the kernel's plain PyTorch version, a CUDA tensor to the kernel, which
launches or raises.  Nothing falls back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.lstm_cell import (
    check_cell_args,
    lstm_cell_cuda,
    lstm_cell_plain,
    pack_weights,
)


def lstm_cell_op(params, x, h, c, *, pwl: bool = False,
                 h_out: Optional[torch.Tensor] = None,
                 c_out: Optional[torch.Tensor] = None):
    """Fused LSTM cell.  ``params`` is the core layout {wx, wh, b} or the
    (wx, wh, b) tuple of :func:`pack_weights` (pack once, call per timestep).
    c is taken in f32, as the kernel keeps it.  Returns (h', c'), written into
    ``h_out`` / ``c_out`` when given (``c_out`` may be ``c``)."""
    wx, wh, b = params if isinstance(params, tuple) else pack_weights(params)
    c = c.float()
    if x.device.type == "cuda":
        return lstm_cell_cuda(x, h, c, wx, wh, b, pwl=pwl, h_out=h_out, c_out=c_out)
    if x.device.type != "cpu":
        raise ValueError(f"lstm_cell_op runs on cuda or cpu tensors, got {x.device}")
    h_out, c_out = check_cell_args(x, h, c, wx, wh, b, h_out, c_out)
    h_new, c_new = lstm_cell_plain(x, h, c, wx, wh, b, pwl=pwl)
    h_out.copy_(h_new)
    c_out.copy_(c_new)
    return h_out, c_out


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel (plain-version calls are not counted)."""
    return {"lstm_cell": lstm_cell_cuda.launches}


def reset_launch_counts() -> None:
    lstm_cell_cuda.launches = 0
