"""Jamba [arXiv:2403.19887]: hybrid Mamba + attention (1:7) with MoE on
every second layer.

Counterpart of ``repro/models/jamba.py``.  Layers come in periods of 8,
attention at position ``cfg.attn_offset`` (4) and Mamba elsewhere, the
MoE layer where ``cfg.is_moe_layer(j)`` (1, 3, 5, 7) and the SwiGLU MLP
elsewhere: Jamba is the one family that reads ``moe.every``.  Params are
stacked per period position: ``positions`` is a tuple of 8 dicts, each leaf
with a leading ``n_periods`` dim, and each period's layers come from one
``unbind`` of every stacked leaf (``models/transformer.py::_unstack``).
There is no positional embedding (attention runs with ``use_rope=False``):
the Mamba layers carry position.  With ``remat`` and grad enabled each
period runs under a non-reentrant ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint(period_fn)``.

The decode state is a tuple over the 8 positions, each stacked over
periods: the attention position holds a KV cache ``{"k", "v"}``
(n_periods, B, S_max, Hkv, hd), the Mamba positions ``{"ssm", "conv"}``
(``layers/mamba.py``).  The prefill returns the same tree with the KV of
the S prompt positions; :func:`stitch_states` puts it into a cache of
``max_len`` positions.  The decode step writes every state in place, so
one captured step serves every token.
"""
from __future__ import annotations

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
from repro_torch.layers.mamba import (
    apply_mamba,
    apply_mamba_step,
    init_mamba,
    init_mamba_state,
    mamba_specs,
    mamba_state_specs,
)
from repro_torch.layers.mlp import apply_mlp, init_mlp, mlp_specs
from repro_torch.layers.moe import apply_moe, apply_moe_ep, init_moe, moe_specs
from repro_torch.layers.norms import apply_norm, init_norm, norm_specs
from repro_torch.models.transformer import _stack_specs, _unstack
from repro_torch.utils import Params

PERIOD = 8


def _n_periods(cfg: ModelConfig) -> int:
    if cfg.num_layers % PERIOD:
        raise ValueError(f"jamba's layer count must be a multiple of {PERIOD}, "
                         f"got {cfg.num_layers}")
    return cfg.num_layers // PERIOD


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _layer_kind(cfg: ModelConfig, j: int) -> tuple[str, str]:
    """(mixer, ffn) for period position j, static per position."""
    mixer = "attn" if j % cfg.attn_every == cfg.attn_offset else "mamba"
    ffn = "moe" if cfg.is_moe_layer(j) else "mlp"
    return mixer, ffn


def position_specs(cfg: ModelConfig, j: int) -> Params:
    mixer, ffn = _layer_kind(cfg, j)
    return {
        "ln1": norm_specs(cfg.norm),
        "ln2": norm_specs(cfg.norm),
        "mixer": attention_specs(cfg) if mixer == "attn" else mamba_specs(cfg),
        "ffn": moe_specs(cfg) if ffn == "moe" else mlp_specs(cfg),
    }


def init_position(generator: torch.Generator, cfg: ModelConfig, j: int, device=None,
                  lead: tuple[int, ...] = ()) -> Params:
    mixer, ffn = _layer_kind(cfg, j)
    init_mixer = init_attention if mixer == "attn" else init_mamba
    return {
        "ln1": init_norm(cfg.norm, cfg.d_model, device, lead),
        "ln2": init_norm(cfg.norm, cfg.d_model, device, lead),
        "mixer": init_mixer(generator, cfg, device, lead),
        "ffn": (init_moe(generator, cfg, device, lead) if ffn == "moe"
                else init_mlp(generator, cfg, device=device, lead=lead)),
    }


def init_jamba(generator: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Params drawn on ``device`` from ``generator`` (which lives there), in
    the reference's distributions; each position's leaves stacked
    (n_periods, ...)."""
    n_p = _n_periods(cfg)
    return {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, device),
        "positions": tuple(init_position(generator, cfg, j, device, lead=(n_p,))
                           for j in range(PERIOD)),
        "ln_f": init_norm(cfg.norm, cfg.d_model, device),
        "unembed": init_unembed(generator, cfg.d_model, cfg.vocab_size, device),
    }


def jamba_specs(cfg: ModelConfig) -> Params:
    return {
        "embed": embedding_specs(),
        "positions": tuple(_stack_specs(position_specs(cfg, j)) for j in range(PERIOD)),
        "ln_f": norm_specs(cfg.norm),
        "unembed": unembed_specs(),
    }


def _ffn(lp: Params, h: torch.Tensor, cfg: ModelConfig, j: int):
    """The position's feed-forward: (out, its aux loss), the MLP's a Python 0.0."""
    if _layer_kind(cfg, j)[1] == "moe":
        if cfg.moe.impl == "ep_a2a":
            return apply_moe_ep(lp["ffn"], h, cfg)
        return apply_moe(lp["ffn"], h, cfg)
    return apply_mlp(lp["ffn"], h, cfg), 0.0


def init_states(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None) -> Params:
    """Zeroed decode state: a tuple over the period positions, stacked over
    periods; the attention position a KV cache of ``max_len`` positions in
    ``dtype``, the Mamba positions ``ssm`` in f32 and ``conv`` in ``dtype``."""
    n_p = _n_periods(cfg)
    states = []
    for j in range(PERIOD):
        one = (init_kv_cache(cfg, batch, max_len, dtype, device)
               if _layer_kind(cfg, j)[0] == "attn"
               else init_mamba_state(cfg, batch, dtype, device))
        states.append({k: v.expand((n_p,) + v.shape).clone() for k, v in one.items()})
    return tuple(states)


def state_specs(cfg: ModelConfig) -> Params:
    out = []
    for j in range(PERIOD):
        mixer, _ = _layer_kind(cfg, j)
        base = kv_cache_specs() if mixer == "attn" else mamba_state_specs()
        out.append(map_specs(lambda axes: (None,) + axes, base))
    return tuple(out)


def _layer_fn(lp: Params, h: torch.Tensor, cfg: ModelConfig, j: int, kv_chunk: int,
              q_chunks: int):
    """Layer j of a period over a sequence: (h, its aux, its state)."""
    hn = apply_norm(lp["ln1"], h, cfg.norm)
    if _layer_kind(cfg, j)[0] == "attn":
        y, (k, v) = apply_attention(lp["mixer"], hn, cfg=cfg, causal=True, use_rope=False,
                                    kv_chunk=kv_chunk, q_chunks=q_chunks, return_kv=True)
        st = {"k": k.to(h.dtype), "v": v.to(h.dtype)}
    else:
        y, st = apply_mamba(lp["mixer"], hn, cfg)
    h = constrain(h + y, ("batch", "sp", None))
    f, aux = _ffn(lp, apply_norm(lp["ln2"], h, cfg.norm), cfg, j)
    return constrain(h + f, ("batch", "sp", None)), aux, st


def _period_fn(lps: list, h: torch.Tensor, cfg: ModelConfig, kv_chunk: int, q_chunks: int):
    """One period's 8 layers: (h, the period's aux, its 8 states)."""
    aux, states = torch.zeros((), dtype=torch.float32, device=h.device), []
    for j, lp in enumerate(lps):
        h, aux_l, st = _layer_fn(lp, h, cfg, j, kv_chunk, q_chunks)
        aux = aux + aux_l
        states.append(st)
    return h, aux, states


def forward(params: Params, h: torch.Tensor, cfg: ModelConfig, *, remat: bool = True,
            kv_chunk: int = 1024, q_chunks: int = 1, collect_state: bool = False):
    """h: (B, S, D) embedded inputs -> (h, aux, states | None): aux the MoE
    layers' aux losses summed, states the decode tree (tuple over positions,
    stacked over periods) with ``collect_state``.  ``remat`` recomputes each
    period in the backward (only when grad is enabled)."""
    n_p = _n_periods(cfg)
    by_position = [_unstack(pos, n_p) for pos in params["positions"]]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    collected = []
    for p in range(n_p):
        lps = [by_position[j][p] for j in range(PERIOD)]
        if remat and torch.is_grad_enabled():
            h, aux_p, states = checkpoint(_period_fn, lps, h, cfg, kv_chunk, q_chunks,
                                          use_reentrant=False, context_fn=recompute_context)
        else:
            h, aux_p, states = _period_fn(lps, h, cfg, kv_chunk, q_chunks)
        aux = aux + aux_p
        if collect_state:
            collected.append(states)
    if not collect_state:
        return h, aux, None
    return h, aux, tuple({k: torch.stack([c[j][k] for c in collected]) for k in collected[0][j]}
                         for j in range(PERIOD))


def train_loss(params: Params, batch: dict, cfg: ModelConfig, *, remat: bool = True,
               loss_chunk: int = 2048, kv_chunk: int = 1024, q_chunks: int = 1,
               aux_weight: float = 0.01, **_) -> tuple[torch.Tensor, dict]:
    """Next-token LM loss plus ``aux_weight`` times the MoE layers' summed
    aux.  batch: tokens (B, S), labels (B, S) [-1 = pad].  Returns (total,
    {"xent", "aux"})."""
    h = embed_tokens(params["embed"], batch["tokens"], _dtype(cfg))
    h, aux, _ = forward(params, h, cfg, remat=remat, kv_chunk=kv_chunk, q_chunks=q_chunks)
    h = apply_norm(params["ln_f"], h, cfg.norm)
    loss = chunked_xent_loss(params["unembed"]["w"], h, batch["labels"], chunk=loss_chunk)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


def prefill(params: Params, batch: dict, cfg: ModelConfig, *, kv_chunk: int = 1024,
            q_chunks: int = 1, **_) -> tuple[torch.Tensor, Params]:
    """The last position's logits (B, 1, V) and the states after the
    prompt: attention ``{"k", "v"}`` (n_periods, B, S, Hkv, hd) in h's
    dtype, Mamba ``{"ssm", "conv"}``."""
    h = embed_tokens(params["embed"], batch["tokens"], _dtype(cfg))
    h, _, states = forward(params, h, cfg, remat=False, kv_chunk=kv_chunk, q_chunks=q_chunks,
                           collect_state=True)
    h = apply_norm(params["ln_f"], h, cfg.norm)
    return unembed_logits(params["unembed"]["w"], h[:, -1:, :]), states


def _decode_layer(lp: Params, st: Params, h: torch.Tensor, cache_len: torch.Tensor,
                  cfg: ModelConfig, j: int) -> torch.Tensor:
    """Layer j of a period for one token h (B, D), its state ``st``
    written in place."""
    hn = apply_norm(lp["ln1"], h, cfg.norm)
    if _layer_kind(cfg, j)[0] == "attn":
        y, _ = decode_attention(lp["mixer"], hn[:, None, :], st, cache_len, cfg=cfg,
                                use_rope=False)
        h = h + y[:, 0, :]
    else:
        h = h + apply_mamba_step(lp["mixer"], hn, cfg, st)[0]
    f, _ = _ffn(lp, apply_norm(lp["ln2"], h, cfg.norm)[:, None, :], cfg, j)
    return h + f[:, 0, :]


def decode_step(params: Params, token: torch.Tensor, states: Params,
                cache_len: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, Params]:
    """One-token decode.  token: (B, 1); states as :func:`init_states` or
    :func:`stitch_states` give them.  Writes the token's K/V at
    ``cache_len`` and the Mamba layers' new states into ``states`` in place
    and returns (logits (B, 1, V), ``states``).  A MoE layer routes the B
    decode tokens together, and its aux loss is dropped."""
    n_p = _n_periods(cfg)
    h = embed_tokens(params["embed"], token, _dtype(cfg))[:, 0, :]      # (B, D)
    by_position = [_unstack(pos, n_p) for pos in params["positions"]]
    for p in range(n_p):
        for j in range(PERIOD):
            h = _decode_layer(by_position[j][p], {k: v[p] for k, v in states[j].items()}, h,
                              cache_len, cfg, j)
    h = apply_norm(params["ln_f"], h, cfg.norm)
    return unembed_logits(params["unembed"]["w"], h[:, None, :]), states


def stitch_states(cfg: ModelConfig, prefill_states: Params, max_len: int) -> Params:
    """The decode state that continues a prefill: each attention position's
    K/V (n_periods, B, S, Hkv, hd) copied into a zeroed cache of ``max_len``
    positions in the K/V's dtype, at [0, S); the Mamba states as they are.
    Decoding then starts at ``cache_len = S``."""
    out = []
    for j, st in enumerate(prefill_states):
        if _layer_kind(cfg, j)[0] != "attn":
            out.append(st)
            continue
        covered = st["k"].shape[2]
        if max_len < covered:
            raise ValueError(f"a decode cache of {max_len} positions cannot hold the "
                             f"{covered} the prefill covered")
        cache = {}
        for name, src in st.items():
            shape = src.shape[:2] + (max_len,) + src.shape[3:]
            cache[name] = torch.zeros(shape, dtype=src.dtype, device=src.device)
            cache[name].narrow(2, 0, covered).copy_(src)
        out.append(cache)
    return tuple(out)
