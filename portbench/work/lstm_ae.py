"""Model work of the LSTM-AE family, counted from a configuration's widths.

The yardstick of the roofline and of ``mfu``: the model's work, whatever kernel
computes it.  One LSTM layer of input width In and hidden width H does two
matrix-vector products per row and timestep, x (In) and h (H) against the four
gates' 4H columns: 2 * 4H * (In + H) = 8 * H * (In + H) FLOP.  The gates'
element-wise update is left out, as the paper and the kernels' own bounds do.

The least bytes of one scoring request are its inputs read once, its scores
written once and the weights read once, all in float32.
"""
from __future__ import annotations

BYTES = 4  # float32


def layer_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(In, H) of every layer: the input width, then each layer's hidden width."""
    hidden = [int(h) for h in cfg["layer_sizes"]]
    inputs = [int(cfg["input_features"])] + hidden[:-1]
    return list(zip(inputs, hidden))


def flops_per_row_timestep(cfg: dict) -> int:
    return sum(8 * h * (i + h) for i, h in layer_shapes(cfg))


def weight_count(cfg: dict) -> int:
    return sum(4 * h * (i + h) + 4 * h for i, h in layer_shapes(cfg))


def request_flops(cfg: dict, rows: int, seq_len: int) -> float:
    return float(rows) * seq_len * flops_per_row_timestep(cfg)


def request_bytes(cfg: dict, rows: int, seq_len: int) -> float:
    inputs = rows * seq_len * int(cfg["input_features"])
    return float(BYTES * (inputs + rows + weight_count(cfg)))
