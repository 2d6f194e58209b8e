"""Decoder-only transformer LM, dense: GQA + RoPE, pre-norm.

Counterpart of ``repro/models/transformer.py`` for the dense configs
(olmo / phi4-mini / tinyllama / internlm2 / phi-3-vision's backbone).  The
layers' params are stacked along a leading layer dim, the reference's
``vmap`` layout ``(L, ...)``, and run in a Python loop over that dim (the
reference's ``lax.scan``).  A config with ``moe`` set raises: the MoE layer
is ROADMAP.md, queue 1, item 11c.  ``train_loss`` comes with LM training
(item 11b); ``remat`` and ``bwd_constrain`` only matter there and are
accepted and ignored here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.core import ModelConfig
from repro_torch.layers.attention import (
    apply_attention,
    decode_attention,
    init_attention,
    init_kv_cache,
)
from repro_torch.layers.embeddings import (
    embed_tokens,
    init_embedding,
    init_unembed,
    unembed_logits,
)
from repro_torch.layers.mlp import apply_mlp, init_mlp
from repro_torch.layers.norms import apply_norm, init_norm
from repro_torch.utils import Params, tree_map

MOE_ITEM = "ROADMAP.md, queue 1, item 11c (layers/moe.py)"


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE transformer is not ported yet: {MOE_ITEM}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def init_layer(generator: torch.Generator, cfg: ModelConfig, device=None,
               lead: tuple[int, ...] = ()) -> Params:
    _require_dense(cfg)
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, device, lead),
        "attn": init_attention(generator, cfg, device, lead),
        "ln2": init_norm(cfg.norm, cfg.d_model, device, lead),
        "mlp": init_mlp(generator, cfg, device=device, lead=lead),
    }


def init_transformer(generator: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Params drawn on ``device`` from ``generator`` (which lives there), in
    the reference's distributions; the layers' leaves stacked (L, ...)."""
    _require_dense(cfg)
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "layers": init_layer(generator, cfg, device, lead=(cfg.num_layers,)),
        "ln_f": init_norm(cfg.norm, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_unembed(generator, cfg.d_model, cfg.vocab_size, device)
    return p


def _unembed_w(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["unembed"]["w"]


def _layer(params: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], params["layers"])


def forward(
    params: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    remat: bool = True,
    kv_chunk: int = 1024,
    q_chunks: int = 1,
    collect_cache: bool = False,
):
    """Run the layer stack on embedded inputs h (B, S, D).

    Returns (h, aux_loss) or, with ``collect_cache``, (h, aux, {"k","v"}
    stacked (L, B, S, Hkv, hd)) for prefill.  The dense stack's aux loss is
    0; ``remat`` is the reference's training option and has no effect here.
    """
    _require_dense(cfg)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        hn = apply_norm(lp["ln1"], h, cfg.norm)
        attn_out, (k, v) = apply_attention(
            lp["attn"], hn, cfg=cfg, causal=causal, positions=positions,
            kv_chunk=kv_chunk, q_chunks=q_chunks, return_kv=True)
        h = h + attn_out
        hn = apply_norm(lp["ln2"], h, cfg.norm)
        h = h + apply_mlp(lp["mlp"], hn, cfg)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    h = apply_norm(params["ln_f"], h, cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if collect_cache:
        return h, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return h, aux


def embed_inputs(params: Params, batch: dict, cfg: ModelConfig, dtype) -> torch.Tensor:
    """Token (+ optional vision-stub patch) embedding: (B, [P +] S, D)."""
    h = embed_tokens(params["embed"], batch["tokens"], dtype)
    if cfg.frontend == "vision_stub" and "image_embeds" in batch:
        img = batch["image_embeds"].to(dtype)  # (B, P, D) precomputed patches
        h = torch.cat([img, h], dim=1)
    return h


def prefill(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    kv_chunk: int = 1024,
    q_chunks: int = 1,
) -> tuple[torch.Tensor, Params]:
    """Prefill: full forward; returns the last position's logits (B, 1, V)
    and the KV cache {"k","v"} (L, B, S, Hkv, hd) over every position it
    covered (S + vision patches under the vision stub)."""
    h = embed_inputs(params, batch, cfg, _dtype(cfg))
    h, _, cache = forward(params, h, cfg, remat=False, kv_chunk=kv_chunk,
                          q_chunks=q_chunks, collect_cache=True)
    logits = unembed_logits(_unembed_w(params, cfg), h[:, -1:, :])
    return logits, cache


def decode_step(
    params: Params,
    token: torch.Tensor,
    cache: Params,
    cache_len: torch.Tensor,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, Params]:
    """One-token decode.  token: (B, 1) int; cache: {"k","v"} stacked
    (L, B, S_max, Hkv, hd) (``decode_loop="scan"``) or a tuple of per-layer
    {"k","v"} (``"unroll"``); cache_len: 0-d int tensor (tokens already
    cached).  Writes each layer's new K/V into ``cache`` in place and
    returns (logits (B, 1, V), cache)."""
    _require_dense(cfg)
    h = embed_tokens(params["embed"], token, _dtype(cfg))
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        cache_l = cache[i] if cfg.decode_loop == "unroll" else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        hn = apply_norm(lp["ln1"], h, cfg.norm)
        attn_out, _ = decode_attention(lp["attn"], hn, cache_l, cache_len, cfg=cfg)
        h = h + attn_out
        hn = apply_norm(lp["ln2"], h, cfg.norm)
        h = h + apply_mlp(lp["mlp"], hn, cfg)
    h = apply_norm(params["ln_f"], h, cfg.norm)
    return unembed_logits(_unembed_w(params, cfg), h), cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> Params:
    """Zeroed decode cache in ``cfg.decode_loop``'s layout."""
    if cfg.decode_loop == "unroll":
        return tuple(init_kv_cache(cfg, batch, max_len, dtype, device)
                     for _ in range(cfg.num_layers))
    hd = cfg.resolved_head_dim()
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
