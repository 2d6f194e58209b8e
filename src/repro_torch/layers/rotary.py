"""Rotary position embeddings (RoPE) [arXiv:2104.09864] and the fixed
sinusoidal table of Whisper's encoder."""
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


def sinusoidal_embedding(seq_len: int, dim: int, max_timescale: float = 10000.0,
                         device=None) -> torch.Tensor:
    """Fixed sinusoidal table (seq_len, dim) in f32 on ``device``: Whisper's
    encoder positions.  The reference's denominator ``max(1, half - 1)``,
    sines in the first half of the columns and cosines in the second."""
    half = dim // 2
    positions = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    timescales = max_timescale ** (torch.arange(half, dtype=torch.float32, device=device)
                                   / max(1, half - 1))
    args = positions / timescales[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
