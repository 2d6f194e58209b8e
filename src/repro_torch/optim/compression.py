"""Gradient compression: int8 quantisation with error feedback (EF-SGD
style [arXiv:1901.09847]).

Counterpart of ``repro/optim/compression.py``.  The quantiser is per-leaf
symmetric (scale = max|g|/127); ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 payload is the reference's bit for bit.
The dequantised value is what enters the optimiser; an all-reduce of the
int8 payload belongs around it once gradients cross devices.
"""
from __future__ import annotations

import torch

from repro_torch.utils import Params, tree_map


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads(grads: Params, error: Params) -> tuple[Params, Params]:
    """Quantise (grads + carried error) to int8; return (dequantised grads,
    new error buffers)."""
    def one(g, e):
        target = g.float() + e
        deq = dequantize_int8(*quantize_int8(target))
        return deq, target - deq

    pairs = tree_map(one, grads, error)
    deq = tree_map(lambda g, pair: pair[0], grads, pairs)
    return deq, tree_map(lambda g, pair: pair[1], grads, pairs)
