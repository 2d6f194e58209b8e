"""Token embedding and unembedding.  ``chunked_xent_loss`` comes with LM
training (ROADMAP.md, queue 1, item 11b)."""
from __future__ import annotations

import torch

from repro_torch.utils import Params, truncated_normal_init


def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   device=None) -> Params:
    return {"table": truncated_normal_init((vocab, d_model), d_model, generator, device)}


def embed_tokens(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, D).  The reference casts the whole table
    and then gathers; a cast is per element, so gathering first gives the
    same bits without casting every row of the table."""
    return params["table"][tokens].to(dtype)


def init_unembed(generator: torch.Generator, d_model: int, vocab: int,
                 device=None) -> Params:
    return {"w": truncated_normal_init((d_model, vocab), d_model, generator, device)}


def unembed_logits(unembed_w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, D) -> (B, S, V) in ``h``'s dtype."""
    return h @ unembed_w.to(h.dtype)
