"""Decoder-only transformer LM: dense or MoE, GQA + RoPE, pre-norm.

Counterpart of ``repro/models/transformer.py``: moonshot / dbrx (MoE) and
olmo / phi4-mini / tinyllama / internlm2 / phi-3-vision's backbone
(dense).  With ``cfg.moe`` set every layer's feed-forward is the MoE
layer (``layers/moe.py``), whatever ``moe.every`` says, as in the
reference (only jamba reads ``every``).  The layers' params are stacked
along a leading layer dim, the reference's ``vmap`` layout ``(L, ...)``,
and run in a Python loop over that dim (the reference's ``lax.scan``).
Each layer's params come from one ``torch.unbind`` of every stacked leaf,
whose backward stacks the layer grads once; with ``remat`` and grad
enabled each layer runs under a non-reentrant ``torch.utils.checkpoint``
(the reference's ``jax.checkpoint(layer_fn)``), so the backward holds one
layer's activations at a time.  The recompute runs the same ops, so it
routes as the forward did.  ``forward`` sums the MoE layers' aux losses;
``train_loss`` is the next-token loss through ``chunked_xent_loss`` plus
``aux_weight`` times that sum.  Under a mesh the residual stream is
pinned to ``("batch", "sp", None)`` after each sublayer, and with
``cfg.bwd_constrain`` at each layer's entry too, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.core import ModelConfig
from repro_torch.distributed.sharding import constrain, map_specs, recompute_context
from repro_torch.layers.attention import (
    apply_attention,
    attention_specs,
    decode_attention,
    init_attention,
    init_kv_cache,
    kv_cache_specs,
)
from repro_torch.layers.embeddings import (
    chunked_xent_loss,
    embed_tokens,
    embedding_specs,
    init_embedding,
    init_unembed,
    unembed_logits,
    unembed_specs,
)
from repro_torch.layers.mlp import apply_mlp, init_mlp, mlp_specs
from repro_torch.layers.moe import apply_moe, apply_moe_ep, init_moe, moe_specs
from repro_torch.layers.norms import apply_norm, init_norm, norm_specs
from repro_torch.utils import Params


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.moe is not None


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def init_layer(generator: torch.Generator, cfg: ModelConfig, device=None,
               lead: tuple[int, ...] = ()) -> Params:
    p = {
        "ln1": init_norm(cfg.norm, cfg.d_model, device, lead),
        "attn": init_attention(generator, cfg, device, lead),
        "ln2": init_norm(cfg.norm, cfg.d_model, device, lead),
    }
    if _is_moe(cfg):
        p["moe"] = init_moe(generator, cfg, device, lead)
    else:
        p["mlp"] = init_mlp(generator, cfg, device=device, lead=lead)
    return p


def layer_specs(cfg: ModelConfig) -> Params:
    s = {
        "ln1": norm_specs(cfg.norm),
        "attn": attention_specs(cfg),
        "ln2": norm_specs(cfg.norm),
    }
    if _is_moe(cfg):
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


def _stack_specs(specs: Params) -> Params:
    """Prepend the stacked-layer dim (replicated) to every leaf spec."""
    return map_specs(lambda axes: (None,) + axes, specs)


def init_transformer(generator: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Params drawn on ``device`` from ``generator`` (which lives there), in
    the reference's distributions; the layers' leaves stacked (L, ...)."""
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "layers": init_layer(generator, cfg, device, lead=(cfg.num_layers,)),
        "ln_f": init_norm(cfg.norm, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_unembed(generator, cfg.d_model, cfg.vocab_size, device)
    return p


def transformer_specs(cfg: ModelConfig) -> Params:
    s = {
        "embed": embedding_specs(),
        "layers": _stack_specs(layer_specs(cfg)),
        "ln_f": norm_specs(cfg.norm),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = unembed_specs()
    return s


def _unembed_w(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["unembed"]["w"]


def _unstack(tree: Params, n: int) -> list[Params]:
    """A dict tree of stacked (n, ...) leaves -> n trees of views, from one
    ``unbind`` per leaf: its backward stacks the n layer grads once, where
    ``a[i]`` per layer would scatter each into a zeroed full-stack buffer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def _ffn(lp: Params, h: torch.Tensor, cfg: ModelConfig):
    """The layer's feed-forward: (out, its aux loss), the dense MLP's aux
    a Python 0.0 (no device work where the caller drops it)."""
    if _is_moe(cfg):
        if cfg.moe.impl == "ep_a2a":
            return apply_moe_ep(lp["moe"], h, cfg)
        return apply_moe(lp["moe"], h, cfg)
    return apply_mlp(lp["mlp"], h, cfg), 0.0


def _layer_fn(lp: Params, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
              causal: bool, kv_chunk: int, q_chunks: int):
    if cfg.bwd_constrain:
        # entry constraint: its backward pins the incoming gradient to the
        # same (batch, sp) layout
        h = constrain(h, ("batch", "sp", None))
    hn = apply_norm(lp["ln1"], h, cfg.norm)
    attn_out, kv = apply_attention(
        lp["attn"], hn, cfg=cfg, causal=causal, positions=positions,
        kv_chunk=kv_chunk, q_chunks=q_chunks, return_kv=True)
    h = constrain(h + attn_out, ("batch", "sp", None))
    hn = apply_norm(lp["ln2"], h, cfg.norm)
    f, aux = _ffn(lp, hn, cfg)
    return constrain(h + f, ("batch", "sp", None)), kv, aux


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
    stacked (L, B, S, Hkv, hd)) for prefill.  aux is the layers' MoE aux
    losses summed (0 for the dense stack).  ``remat`` recomputes each layer
    in the backward (only when grad is enabled: without it nothing is saved
    anyway).
    """
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    layer_args = (positions, cfg, causal, kv_chunk, q_chunks)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs = [], []
    for lp in _unstack(params["layers"], cfg.num_layers):
        if remat and torch.is_grad_enabled():
            h, (k, v), aux_l = checkpoint(_layer_fn, lp, h, *layer_args, use_reentrant=False,
                                          context_fn=recompute_context)
        else:
            h, (k, v), aux_l = _layer_fn(lp, h, *layer_args)
        aux = aux + aux_l
        if collect_cache:
            ks.append(k)
            vs.append(v)
    h = apply_norm(params["ln_f"], h, cfg.norm)
    if collect_cache:
        return h, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return h, aux


def embed_inputs(params: Params, batch: dict, cfg: ModelConfig, dtype) -> torch.Tensor:
    """Token (+ optional vision-stub patch) embedding: (B, [P +] S, D)."""
    h = embed_tokens(params["embed"], batch["tokens"], dtype)
    if cfg.frontend == "vision_stub" and "image_embeds" in batch:
        img = batch["image_embeds"].to(dtype)  # (B, P, D) precomputed patches
        h = constrain(torch.cat([img, h], dim=1), ("batch", "sp", None))
    return h


def train_loss(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    remat: bool = True,
    loss_chunk: int = 2048,
    kv_chunk: int = 1024,
    q_chunks: int = 1,
    aux_weight: float = 0.01,
) -> tuple[torch.Tensor, dict]:
    """Next-token LM loss.  batch: tokens (B, S), labels (B, S) [-1 = pad],
    optionally image_embeds (B, P, D) under the vision stub, whose P patch
    positions get label -1.  Returns (total, {"xent", "aux"})."""
    h = embed_inputs(params, batch, cfg, _dtype(cfg))
    labels = batch["labels"]
    if cfg.frontend == "vision_stub" and "image_embeds" in batch:
        pad = torch.full((labels.shape[0], batch["image_embeds"].shape[1]), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    h, aux = forward(params, h, cfg, remat=remat, kv_chunk=kv_chunk, q_chunks=q_chunks)
    loss = chunked_xent_loss(_unembed_w(params, cfg), h, labels, chunk=loss_chunk)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


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
    returns (logits (B, 1, V), cache).  A MoE layer routes the B decode
    tokens together, and its aux loss is dropped."""
    h = constrain(embed_tokens(params["embed"], token, _dtype(cfg)), ("batch", None, None))
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        cache_l = cache[i] if cfg.decode_loop == "unroll" else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        hn = apply_norm(lp["ln1"], h, cfg.norm)
        attn_out, _ = decode_attention(lp["attn"], hn, cache_l, cache_len, cfg=cfg)
        h = h + attn_out
        hn = apply_norm(lp["ln2"], h, cfg.norm)
        f, _ = _ffn(lp, hn, cfg)
        h = h + f
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


def decode_cache_specs(cfg: ModelConfig) -> Params:
    if cfg.decode_loop == "unroll":
        return tuple(kv_cache_specs() for _ in range(cfg.num_layers))
    return map_specs(lambda axes: (None,) + axes, kv_cache_specs())


def stitch_decode_cache(cfg: ModelConfig, prefill_cache: Params, max_len: int) -> Params:
    """A decode cache of ``max_len`` positions in ``cfg.decode_loop``'s
    layout, holding the prefill's K/V (L, B, S, Hkv, hd) at positions
    [0, S), where S is every position the prefill covered (under the vision
    stub, the patches too).  Decoding then starts at ``cache_len = S``."""
    k = prefill_cache["k"]
    covered = k.shape[2]
    if max_len < covered:
        raise ValueError(f"a decode cache of {max_len} positions cannot hold the "
                         f"{covered} the prefill covered")
    cache = init_decode_cache(cfg, k.shape[1], max_len, device=k.device)
    layers = cache if cfg.decode_loop == "unroll" else (cache,)
    for i, layer in enumerate(layers):
        for name in ("k", "v"):
            src = prefill_cache[name] if cfg.decode_loop != "unroll" else prefill_cache[name][i]
            layer[name].narrow(-3, 0, covered).copy_(src)
    return cache
