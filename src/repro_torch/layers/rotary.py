"""Rotary position embeddings (RoPE) [arXiv:2104.09864]."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for each rotated pair: (head_dim // 2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, head_dim) by per-position angles, in f32.

    ``positions`` broadcasts against the sequence dim: (S,) or (B, S).
    Half-split convention (rotate_half), matching llama-family checkpoints.
    """
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, device=x.device)      # (hd/2,)
    angles = positions[..., None].float() * inv_freq                   # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                              # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)
