"""Plain linear layers: ``w`` is (d_in, d_out), applied as ``x @ w``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils import Params, truncated_normal_init


def init_linear(generator: torch.Generator, d_in: int, d_out: int, bias: bool = False,
                device=None, lead: tuple[int, ...] = ()) -> Params:
    """``lead`` prepends dims to every leaf (a stack of layers, drawn at once)."""
    p = {"w": truncated_normal_init(lead + (d_in, d_out), d_in, generator, device)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=torch.float32, device=device)
    return p


def linear_specs(in_axis: Optional[str], out_axis: Optional[str], bias: bool = False) -> Params:
    """Logical-axis specs matching :func:`init_linear` (no ``lead`` dims)."""
    s = {"w": (in_axis, out_axis)}
    if bias:
        s["b"] = (out_axis,)
    return s


def apply_linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Weights are cast to ``x``'s dtype at use, as in the reference."""
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y
