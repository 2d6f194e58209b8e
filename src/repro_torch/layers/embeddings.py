"""Token embedding + unembedding with vocab sharding, and chunked
cross-entropy (never materialises full (B, S, V) logits, not even for the
backward)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain, lay_out, recompute_context
from repro_torch.utils import Params, truncated_normal_init


def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   device=None) -> Params:
    return {"table": truncated_normal_init((vocab, d_model), d_model, generator, device)}


def embedding_specs() -> Params:
    return {"table": ("tp", "fsdp")}


def embed_tokens(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, D).  The reference casts the whole table
    and then gathers; a cast is per element, so gathering first gives the
    same bits without casting every row of the table."""
    return constrain(params["table"][tokens].to(dtype), ("batch", "sp", None))


def init_unembed(generator: torch.Generator, d_model: int, vocab: int,
                 device=None) -> Params:
    return {"w": truncated_normal_init((d_model, vocab), d_model, generator, device)}


def unembed_specs() -> Params:
    return {"w": ("fsdp", "tp")}


def _vocab_sharded(unembed_w: torch.Tensor) -> torch.Tensor:
    """The unembedding (D, V) as its product reads it under a mesh: D whole,
    the vocab over the model axis, unevenly where the axis does not divide
    it (whisper's 51,866 over 16, placed replicated), as XLA pads it, so
    that each rank computes its block of the logits.  ``unembed_w`` itself
    without a mesh."""
    return lay_out(unembed_w, (None, "tp"), even=False)


def unembed_logits(unembed_w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, D) -> (B, S, V) in ``h``'s dtype."""
    return constrain(h @ _vocab_sharded(unembed_w).to(h.dtype), ("batch", None, "tp"))


def _chunk_nll(hb: torch.Tensor, unembed_w: torch.Tensor, lb: torch.Tensor,
               z_loss: float) -> torch.Tensor:
    """Summed masked NLL of one chunk: hb (B, c, D), lb (B, c)."""
    logits = constrain(hb @ _vocab_sharded(unembed_w).to(hb.dtype),
                       ("batch", None, "tp")).float()                     # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit keeps its trailing dim until the subtraction: a gather
    # over vocab-sharded logits is masked per shard, and DTensor applies
    # that mask to a tensor of the gather's own rank
    gold = torch.gather(logits, -1, torch.clamp(lb, min=0).long()[..., None])
    nll = (lse[..., None] - gold)[..., 0]
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return torch.sum(nll * (lb >= 0).float())


def chunked_xent_loss(
    unembed_w: torch.Tensor,
    h: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk: int = 2048,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Mean next-token cross-entropy over sequence chunks, in f32.

    h: (B, S, D) final hidden states; labels: (B, S) int (-1 = ignore).
    The reference's scan: S padded to a multiple of ``chunk`` with label
    -1, each chunk's logits (B, chunk, V) cast to f32, logsumexp minus the
    gold logit (gathered at ``max(label, 0)``), plus ``z_loss * lse**2``,
    masked by ``label >= 0``; the sum over chunks over ``max(count, 1)``.
    With grad enabled each chunk runs under a non-reentrant checkpoint, so
    the backward recomputes one chunk's logits at a time (the same ops in
    the same order: the numbers do not change) and never holds them all.
    """
    b, s, d = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # zeros by cat, not F.pad: torch 2.11's DTensor mis-places a padded
        # DTensor (h under a mesh)
        h = torch.cat([h, torch.zeros((b, pad, d), dtype=h.dtype, device=h.device)], dim=1)
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s + pad, chunk):
        hb, lb = h[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, hb, unembed_w, lb, z_loss,
                                       use_reentrant=False, context_fn=recompute_context)
        else:
            total = total + _chunk_nll(hb, unembed_w, lb, z_loss)
    count = torch.sum((labels >= 0).float())
    return total / torch.clamp(count, min=1.0)
