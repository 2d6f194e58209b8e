"""Whisper [arXiv:2212.04356] encoder-decoder backbone.

Counterpart of ``repro/models/whisper.py``.  The mel-spectrogram/conv
frontend is a stub, as in the reference: a batch carries precomputed frame
embeddings ``frames`` (B, T_enc, D).  Encoder: bidirectional attention,
sinusoidal positions.  Decoder: causal self-attention, cross-attention on
the encoder's memory, learned positions ``dec_pos``.  Every layer is
pre-LayerNorm with a tanh-GELU MLP, and the unembedding is the tied
``embed.table.T``.  Attention runs through ``layers/attention.py``'s
blocked softmax, as the reference's does through its jnp path: no kernel.

The layers' params are stacked along a leading layer dim per stack
(``enc_layers``, ``dec_layers``), the reference's ``vmap`` layout, and run
in a Python loop over one ``unbind`` of every stacked leaf
(``models/transformer.py::_unstack``); with ``remat`` and grad enabled
each layer runs under a non-reentrant ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint(layer_fn)``.

The decode cache is ``{"k", "v"}`` (L, B, S_max, Hkv, hd), the decoder's
self-attention KV, and ``{"ck", "cv"}`` (L, B, T_enc, Hkv, hd), the
cross-attention's K/V of the encoder's memory.  The prefill returns the
same tree over the S prompt positions; :func:`stitch_decode_cache` puts the
self-KV into a cache of ``max_len`` positions and passes ``ck``/``cv``
through.  The decode step writes the token's self-KV in place and never
writes ``ck``/``cv``; it reads ``dec_pos`` at ``cache_len`` on the device,
so one captured step serves every token.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.core import ModelConfig
from repro_torch.distributed.sharding import constrain, recompute_context
from repro_torch.layers.attention import (
    apply_attention,
    attention_specs,
    decode_attention,
    init_attention,
    kv_cache_specs,
)
from repro_torch.layers.embeddings import (
    chunked_xent_loss,
    embed_tokens,
    embedding_specs,
    init_embedding,
    unembed_logits,
)
from repro_torch.layers.linear import apply_linear
from repro_torch.layers.mlp import apply_mlp, init_mlp, mlp_specs
from repro_torch.layers.norms import apply_norm, init_norm, norm_specs
from repro_torch.layers.rotary import sinusoidal_embedding
from repro_torch.models.transformer import _stack_specs, _unstack
from repro_torch.utils import Params, truncated_normal_init

MAX_DECODER_LEN = 32_768  # sized for the reference's decode_32k shape
NORM = "layernorm"


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def init_enc_layer(generator: torch.Generator, cfg: ModelConfig, device=None,
                   lead: tuple[int, ...] = ()) -> Params:
    return {
        "ln1": init_norm(NORM, cfg.d_model, device, lead),
        "attn": init_attention(generator, cfg, device, lead),
        "ln2": init_norm(NORM, cfg.d_model, device, lead),
        "mlp": init_mlp(generator, cfg, device=device, lead=lead),
    }


def enc_layer_specs(cfg: ModelConfig) -> Params:
    return {
        "ln1": norm_specs("layernorm"),
        "attn": attention_specs(cfg),
        "ln2": norm_specs("layernorm"),
        "mlp": mlp_specs(cfg),
    }


def init_dec_layer(generator: torch.Generator, cfg: ModelConfig, device=None,
                   lead: tuple[int, ...] = ()) -> Params:
    return {
        "ln1": init_norm(NORM, cfg.d_model, device, lead),
        "self_attn": init_attention(generator, cfg, device, lead),
        "ln_x": init_norm(NORM, cfg.d_model, device, lead),
        "cross_attn": init_attention(generator, cfg, device, lead),
        "ln2": init_norm(NORM, cfg.d_model, device, lead),
        "mlp": init_mlp(generator, cfg, device=device, lead=lead),
    }


def dec_layer_specs(cfg: ModelConfig) -> Params:
    return {
        "ln1": norm_specs("layernorm"),
        "self_attn": attention_specs(cfg),
        "ln_x": norm_specs("layernorm"),
        "cross_attn": attention_specs(cfg),
        "ln2": norm_specs("layernorm"),
        "mlp": mlp_specs(cfg),
    }


def init_whisper(generator: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Params drawn on ``device`` from ``generator`` (which lives there), in
    the reference's distributions; each stack's leaves stacked (L, ...)."""
    return {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "dec_pos": truncated_normal_init((MAX_DECODER_LEN, cfg.d_model), cfg.d_model,
                                         generator, device),
        "enc_layers": init_enc_layer(generator, cfg, device, lead=(cfg.encoder_layers,)),
        "ln_enc": init_norm(NORM, cfg.d_model, device),
        "dec_layers": init_dec_layer(generator, cfg, device, lead=(cfg.num_layers,)),
        "ln_dec": init_norm(NORM, cfg.d_model, device),
    }


def whisper_specs(cfg: ModelConfig) -> Params:
    return {
        "embed": embedding_specs(),
        "dec_pos": (None, "fsdp"),
        "enc_layers": _stack_specs(enc_layer_specs(cfg)),
        "ln_enc": norm_specs("layernorm"),
        "dec_layers": _stack_specs(dec_layer_specs(cfg)),
        "ln_dec": norm_specs("layernorm"),
    }


def _enc_layer(lp: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    hn = apply_norm(lp["ln1"], h, NORM)
    h = constrain(h + apply_attention(lp["attn"], hn, cfg=cfg, causal=False, use_rope=False),
                  ("batch", "sp", None))
    return constrain(h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, NORM), cfg),
                     ("batch", "sp", None))


def _dec_layer(lp: Params, h: torch.Tensor, memory: torch.Tensor, cfg: ModelConfig,
               kv_chunk: int, q_chunks: int):
    """One decoder layer over a sequence: (h, its self K/V, its cross K/V).
    The cross K/V are the cross-attention's own projections of ``memory``
    (the reference's ``_cross_kv``, the same ops)."""
    hn = apply_norm(lp["ln1"], h, NORM)
    y, kv = apply_attention(lp["self_attn"], hn, cfg=cfg, causal=True, use_rope=False,
                            kv_chunk=kv_chunk, q_chunks=q_chunks, return_kv=True)
    h = constrain(h + y, ("batch", "sp", None))
    hn = apply_norm(lp["ln_x"], h, NORM)
    y, ckv = apply_attention(lp["cross_attn"], hn, cfg=cfg, causal=False, use_rope=False,
                             x_kv=memory, return_kv=True)
    h = constrain(h + y, ("batch", "sp", None))
    h = constrain(h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, NORM), cfg), ("batch", "sp", None))
    return h, kv, ckv


def _run(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward under ``remat`` (only when
    grad is enabled: without it nothing is saved anyway)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, context_fn=recompute_context)
    return fn(*args)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, T_enc, D) stub frame embeddings -> encoder memory."""
    pos = sinusoidal_embedding(frames.shape[1], cfg.d_model, device=frames.device)
    h = constrain(frames + pos.to(frames.dtype), ("batch", "sp", None))
    for lp in _unstack(params["enc_layers"], cfg.encoder_layers):
        h = _run(_enc_layer, remat, lp, h, cfg)
    return apply_norm(params["ln_enc"], h, NORM)


def _embed(params: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token embedding plus the learned positions [0, S)."""
    h = embed_tokens(params["embed"], tokens, dtype)
    return h + params["dec_pos"][: tokens.shape[1]].to(dtype)[None]


def decode_train(params: Params, tokens: torch.Tensor, memory: torch.Tensor, cfg: ModelConfig,
                 *, remat: bool = True, kv_chunk: int = 1024,
                 q_chunks: int = 1) -> torch.Tensor:
    """Teacher-forced decoder pass -> final hidden states (B, S, D)."""
    h = constrain(_embed(params, tokens, memory.dtype), ("batch", "sp", None))
    for lp in _unstack(params["dec_layers"], cfg.num_layers):
        h = _run(_dec_layer, remat, lp, h, memory, cfg, kv_chunk, q_chunks)[0]
    return apply_norm(params["ln_dec"], h, NORM)


def train_loss(params: Params, batch: dict, cfg: ModelConfig, *, remat: bool = True,
               loss_chunk: int = 2048, kv_chunk: int = 1024, q_chunks: int = 1,
               **_) -> tuple[torch.Tensor, dict]:
    """batch: frames (B, T_enc, D), tokens (B, S), labels (B, S) [-1 = pad].
    Returns (xent, {"xent"})."""
    memory = encode(params, batch["frames"].to(_dtype(cfg)), cfg, remat=remat)
    h = decode_train(params, batch["tokens"], memory, cfg, remat=remat, kv_chunk=kv_chunk,
                     q_chunks=q_chunks)
    loss = chunked_xent_loss(params["embed"]["table"].T, h, batch["labels"], chunk=loss_chunk)
    return loss, {"xent": loss}


# --- serving -----------------------------------------------------------

def _cross_kv(lp: Params, memory: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V (B, T_enc, Hkv, hd) of one layer from the
    encoder's memory."""
    hd = cfg.resolved_head_dim()
    b, t, _ = memory.shape
    k = apply_linear(lp["cross_attn"]["k"], memory).reshape(b, t, cfg.num_kv_heads, hd)
    v = apply_linear(lp["cross_attn"]["v"], memory).reshape(b, t, cfg.num_kv_heads, hd)
    return k, v


def prefill(params: Params, batch: dict, cfg: ModelConfig, *, kv_chunk: int = 1024,
            q_chunks: int = 1, **_) -> tuple[torch.Tensor, Params]:
    """Encode the frames, run the prompt teacher-forced: the last position's
    logits (B, 1, V) and the cache ``{"k", "v"}`` (L, B, S, Hkv, hd) and
    ``{"ck", "cv"}`` (L, B, T_enc, Hkv, hd), in compute dtype."""
    dtype = _dtype(cfg)
    memory = encode(params, batch["frames"].to(dtype), cfg, remat=False)
    h = _embed(params, batch["tokens"], dtype)
    cache: dict = {"k": [], "v": [], "ck": [], "cv": []}
    for lp in _unstack(params["dec_layers"], cfg.num_layers):
        h, (k, v), (ck, cv) = _dec_layer(lp, h, memory, cfg, kv_chunk, q_chunks)
        for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
            cache[name].append(t.to(dtype))
    h = apply_norm(params["ln_dec"], h, NORM)
    logits = unembed_logits(params["embed"]["table"].T, h[:, -1:, :])
    return logits, {name: torch.stack(ts) for name, ts in cache.items()}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> Params:
    """Zeroed decode cache: self-KV of ``max_len`` positions, cross-KV of
    ``cfg.encoder_seq_len`` frames, each (L, B, ·, Hkv, hd)."""
    hd = cfg.resolved_head_dim()
    lead = (cfg.num_layers, batch)
    self_shape = lead + (max_len, cfg.num_kv_heads, hd)
    cross_shape = lead + (cfg.encoder_seq_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
            "v": torch.zeros(self_shape, dtype=dtype, device=device),
            "ck": torch.zeros(cross_shape, dtype=dtype, device=device),
            "cv": torch.zeros(cross_shape, dtype=dtype, device=device)}


def decode_cache_specs(cfg: ModelConfig) -> Params:
    base = kv_cache_specs()
    return {
        "k": (None,) + base["k"],
        "v": (None,) + base["v"],
        "ck": (None, "batch", "tp", None, None),
        "cv": (None, "batch", "tp", None, None),
    }


def _decode_layer(lp: Params, cache_l: Params, h: torch.Tensor, cache_len: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One decoder layer for one token h (B, 1, D) against its caches
    ``cache_l`` ({"k", "v", "ck", "cv"}, each (B, ·, Hkv, hd)): the self K/V
    written at ``cache_len`` in place, ``ck``/``cv`` only read, with every
    frame visible (a Python int: no copy from the host)."""
    hn = apply_norm(lp["ln1"], h, NORM)
    y, _ = decode_attention(lp["self_attn"], hn, {"k": cache_l["k"], "v": cache_l["v"]},
                            cache_len, cfg=cfg, use_rope=False)
    h = h + y
    hn = apply_norm(lp["ln_x"], h, NORM)
    y, _ = decode_attention(lp["cross_attn"], hn, {"k": cache_l["ck"], "v": cache_l["cv"]},
                            cfg.encoder_seq_len - 1, cfg=cfg, use_rope=False, update_cache=False)
    h = h + y
    return h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, NORM), cfg)


def decode_step(params: Params, token: torch.Tensor, cache: Params, cache_len: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, Params]:
    """One decoder token against the self-KV cache and the fixed cross-KV.
    token: (B, 1) int; cache_len: 0-d int tensor (tokens already cached).
    Writes the token's self K/V at ``cache_len`` into ``cache`` in place,
    reads ``ck``/``cv`` and returns (logits (B, 1, V), ``cache``)."""
    dtype = _dtype(cfg)
    cache_len = torch.as_tensor(cache_len, device=token.device)
    # dynamic_slice clamps its start into range; so does this
    row = torch.clamp(cache_len.reshape(1).long(), 0, params["dec_pos"].shape[0] - 1)
    h = embed_tokens(params["embed"], token, dtype)
    h = h + params["dec_pos"].index_select(0, row).to(dtype)[None]
    for i, lp in enumerate(_unstack(params["dec_layers"], cfg.num_layers)):
        h = _decode_layer(lp, {name: t[i] for name, t in cache.items()}, h, cache_len, cfg)
    h = apply_norm(params["ln_dec"], h, NORM)
    return unembed_logits(params["embed"]["table"].T, h), cache


def stitch_decode_cache(cfg: ModelConfig, prefill_cache: Params, max_len: int) -> Params:
    """The decode cache that continues a prefill: its self K/V
    (L, B, S, Hkv, hd) copied into a zeroed cache of ``max_len`` positions
    in the K/V's dtype, at [0, S); ``ck``/``cv`` as they are.  Decoding
    then starts at ``cache_len = S``."""
    covered = prefill_cache["k"].shape[2]
    if max_len < covered:
        raise ValueError(f"a decode cache of {max_len} positions cannot hold the "
                         f"{covered} the prefill covered")
    cache = {}
    for name in ("k", "v"):
        src = prefill_cache[name]
        cache[name] = torch.zeros(src.shape[:2] + (max_len,) + src.shape[3:], dtype=src.dtype,
                                  device=src.device)
        cache[name].narrow(2, 0, covered).copy_(src)
    return dict(cache, ck=prefill_cache["ck"], cv=prefill_cache["cv"])
