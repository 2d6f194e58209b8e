"""RWKV-6 "Finch" language model [arXiv:2404.05892].

Counterpart of ``repro/models/rwkv6.py``.  Attention-free: a per-token
recurrence with per-layer state carried from one timestep to the next, the
LM closest to the paper's own setting.  Train (the WKV scan under
:class:`~repro_torch.layers.rwkv.WKV6`), prefill (the same scan, emitting
the final states) and decode (one recurrence step) all run K3 on CUDA
(``layers/rwkv.py``): one launch per layer per call.

The layers' params are stacked along a leading layer dim ``(L, ...)`` and
taken per layer from one ``unbind`` (``models/transformer.py::_unstack``);
with ``remat`` and grad enabled each layer runs under a non-reentrant
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).  The
state is a tree ``{"tm_x", "wkv", "cm_x"}`` of stacked (L, B, ...)
leaves: the token-shift inputs in the compute dtype (``init_state``'s
dtype) and the WKV state in f32.  It is position-free, so the prefill's
state is the decode cache as it is, and ``cache_len`` is ignored; the
decode step writes it in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.core import ModelConfig
from repro_torch.layers.embeddings import (
    chunked_xent_loss,
    embed_tokens,
    embedding_specs,
    init_embedding,
    init_unembed,
    unembed_logits,
    unembed_specs,
)
from repro_torch.layers.norms import apply_norm, init_norm, norm_specs
from repro_torch.layers.rwkv import (
    apply_channel_mix,
    apply_time_mix,
    apply_time_mix_step,
    channel_mix_specs,
    init_channel_mix,
    init_time_mix,
    time_mix_specs,
)
from repro_torch.models.transformer import _stack_specs, _unstack
from repro_torch.utils import Params

STATE_KEYS = ("tm_x", "wkv", "cm_x")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def init_layer(generator: torch.Generator, cfg: ModelConfig, device=None,
               lead: tuple[int, ...] = ()) -> Params:
    return {
        "ln1": init_norm("layernorm", cfg.d_model, device, lead),
        "tm": init_time_mix(generator, cfg, device, lead),
        "ln2": init_norm("layernorm", cfg.d_model, device, lead),
        "cm": init_channel_mix(generator, cfg, device, lead),
    }


def layer_specs(cfg: ModelConfig) -> Params:
    return {
        "ln1": norm_specs("layernorm"),
        "tm": time_mix_specs(cfg),
        "ln2": norm_specs("layernorm"),
        "cm": channel_mix_specs(cfg),
    }


def init_rwkv6(generator: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Params drawn on ``device`` from ``generator`` (which lives there), in
    the reference's distributions; the layers' leaves stacked (L, ...)."""
    return {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "ln0": init_norm("layernorm", cfg.d_model, device),
        "layers": init_layer(generator, cfg, device, lead=(cfg.num_layers,)),
        "ln_f": init_norm("layernorm", cfg.d_model, device),
        "unembed": init_unembed(generator, cfg.d_model, cfg.vocab_size, device),
    }


def rwkv6_specs(cfg: ModelConfig) -> Params:
    return {
        "embed": embedding_specs(),
        "ln0": norm_specs("layernorm"),
        "layers": _stack_specs(layer_specs(cfg)),
        "ln_f": norm_specs("layernorm"),
        "unembed": unembed_specs(),
    }


def init_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> Params:
    """Zeroed recurrent state, stacked (L, ...): the token-shift inputs in
    ``dtype``, the WKV state in f32."""
    h, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    n, d = cfg.num_layers, cfg.d_model
    return {
        "tm_x": torch.zeros((n, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((n, batch, h, hd, hd), dtype=torch.float32, device=device),
        "cm_x": torch.zeros((n, batch, d), dtype=dtype, device=device),
    }


def state_specs() -> Params:
    return {
        "tm_x": (None, "batch", None),
        "wkv": (None, "batch", "tp", None, None),
        "cm_x": (None, "batch", None),
    }


def _stack(states: list[Params]) -> Params:
    return {k: torch.stack([st[k] for st in states]) for k in STATE_KEYS}


def _layer_fn(lp: Params, st: Params, h: torch.Tensor, cfg: ModelConfig, chunk: int):
    y, (tm_x, wkv) = apply_time_mix(
        lp["tm"], apply_norm(lp["ln1"], h, "layernorm"), cfg,
        x_prev=st["tm_x"].to(h.dtype), state=st["wkv"], chunk=chunk)
    h = h + y
    y, cm_x = apply_channel_mix(lp["cm"], apply_norm(lp["ln2"], h, "layernorm"), cfg,
                                x_prev=st["cm_x"].to(h.dtype))
    h = h + y
    return h, {"tm_x": tm_x.to(st["tm_x"].dtype), "wkv": wkv,
               "cm_x": cm_x.to(st["cm_x"].dtype)}


def forward(params: Params, h: torch.Tensor, cfg: ModelConfig, state: Params | None = None,
            *, remat: bool = True, chunk: int = 64):
    """h: (B, S, D) embedded inputs -> (h, new_state).  ``remat`` recomputes
    each layer in the backward (only when grad is enabled)."""
    if state is None:
        state = init_state(cfg, h.shape[0], h.dtype, device=h.device)
    n = cfg.num_layers
    new = []
    for lp, st in zip(_unstack(params["layers"], n), _unstack(state, n)):
        if remat and torch.is_grad_enabled():
            h, st = checkpoint(_layer_fn, lp, st, h, cfg, chunk, use_reentrant=False)
        else:
            h, st = _layer_fn(lp, st, h, cfg, chunk)
        new.append(st)
    return h, _stack(new)


def train_loss(params: Params, batch: dict, cfg: ModelConfig, *,
               remat: bool = True, loss_chunk: int = 2048, **_) -> tuple[torch.Tensor, dict]:
    """Next-token LM loss.  batch: tokens (B, S), labels (B, S) [-1 = pad].
    Returns (loss, {"xent"})."""
    h = embed_tokens(params["embed"], batch["tokens"], _dtype(cfg))
    h = apply_norm(params["ln0"], h, "layernorm")
    h, _ = forward(params, h, cfg, remat=remat)
    h = apply_norm(params["ln_f"], h, "layernorm")
    loss = chunked_xent_loss(params["unembed"]["w"], h, batch["labels"], chunk=loss_chunk)
    return loss, {"xent": loss}


def prefill(params: Params, batch: dict, cfg: ModelConfig, **_) -> tuple[torch.Tensor, Params]:
    """Prefill = run the recurrence over the prompt: the last position's
    logits (B, 1, V) and the final state, which is the decode cache."""
    h = embed_tokens(params["embed"], batch["tokens"], _dtype(cfg))
    h = apply_norm(params["ln0"], h, "layernorm")
    h, state = forward(params, h, cfg, remat=False)
    h = apply_norm(params["ln_f"], h, "layernorm")
    return unembed_logits(params["unembed"]["w"], h[:, -1:, :]), state


def decode_step(params: Params, token: torch.Tensor, state: Params,
                cache_len: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, Params]:
    """One-token decode.  token: (B, 1).  Writes the new state into
    ``state`` in place, as the transformer's decode writes its KV cache,
    and returns (logits (B, 1, V), ``state``)."""
    del cache_len  # recurrent state is position-free
    h = embed_tokens(params["embed"], token, _dtype(cfg))[:, 0, :]  # (B, D)
    h = apply_norm(params["ln0"], h, "layernorm")
    n = cfg.num_layers
    for i, lp in enumerate(_unstack(params["layers"], n)):
        st = {key: state[key][i] for key in STATE_KEYS}
        y, (tm_x, wkv) = apply_time_mix_step(
            lp["tm"], apply_norm(lp["ln1"], h, "layernorm"), cfg,
            st["tm_x"].to(h.dtype), st["wkv"])
        h = h + y
        y3, cm_x = apply_channel_mix(
            lp["cm"], apply_norm(lp["ln2"], h, "layernorm")[:, None, :], cfg,
            x_prev=st["cm_x"].to(h.dtype))
        h = h + y3[:, 0, :]
        for key, new in (("tm_x", tm_x), ("wkv", wkv), ("cm_x", cm_x)):
            st[key].copy_(new)
    h = apply_norm(params["ln_f"], h, "layernorm")
    return unembed_logits(params["unembed"]["w"], h[:, None, :]), state
