"""DeepSeek-V3 decoder LM (Moonlight-16B-A3B): latent attention in every
layer, ``first_k_dense_replace`` leading dense SwiGLU layers, then
DeepSeek-MoE layers (``layers/moe.py``: sigmoid routing with a correction
bias, shared experts, dropless), pre-norm RMSNorm, untied embeddings.

The layers' params are stacked along a leading layer dim, one stack for the
dense layers (``"dense"``) and one for the MoE layers (``"moe"``), and run
in a Python loop over it, as ``models/transformer.py``'s are.  Weights take
``cfg.param_dtype`` (the served configuration's is bf16, the published
checkpoint's); norm scales and the routers' correction bias stay f32.  A
weight is drawn in f32 and rounded into its dtype a block of rows at a
time, so drawing never holds a whole stack in f32.

The residual stream is f32: each sublayer reads its RMSNorm's f32 output
rounded to the compute dtype for its products (the router reads it
unrounded) and adds its output back in f32.  Every product stays in the
compute dtype; what the f32 stream saves is the rounding of the stream
itself at each of 54 adds, whose drift would otherwise move the routers'
inputs and swap experts at near-ties.

Serving only: ``prefill`` runs the expanded attention and the grouped
experts and returns the last position's logits and every layer's latents
(L, B, S, C + rope); ``decode_step`` runs the absorbed attention over the
latent cache {"latent": (L, B, S_max, C + rope)}, written in place at
``cache_len``, and the padded experts, with no host sync, so a step
captures into one CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.deepseek import DeepSeekV3Config
from repro_torch.layers.embeddings import embed_tokens, unembed_logits
from repro_torch.layers.mla import (
    decode_step_tables,
    mla_decode,
    mla_prefill,
    mla_shapes,
    mla_specs,
    rope_table,
)
from repro_torch.layers.moe import (
    apply_deepseek_moe,
    deepseek_moe_specs,
    init_deepseek_moe,
    swiglu_ffn,
)
from repro_torch.models.transformer import _unstack
from repro_torch.utils import Params

DRAW_BLOCK = 1 << 26   # f32 values drawn at a time


def _drawer(generator: torch.Generator, cfg: DeepSeekV3Config, device):
    """``draw(shape, fan_in)``: a weight of ``shape`` in ``cfg.param_dtype``,
    truncated normal at std 1/sqrt(fan_in) cut at 2 std (the port's
    ``truncated_normal_init``), drawn from ``generator`` a block of rows at a
    time; on the meta device, nothing drawn."""
    dtype = getattr(torch, cfg.param_dtype)

    def draw(shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=device)
        if out.device.type == "meta":
            return out
        rows = out.view(-1, shape[-1])
        step = max(1, DRAW_BLOCK // shape[-1])
        for block in rows.split(step):
            t = torch.empty(block.shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            block.copy_(t.mul_(1.0 / math.sqrt(fan_in)))
        return out

    return draw


def _norm(lead: tuple[int, ...], dim: int, device) -> Params:
    return {"scale": torch.ones(lead + (dim,), dtype=torch.float32, device=device)}


def _init_layers(generator, cfg: DeepSeekV3Config, draw, device, n: int, moe: bool) -> Params:
    lead = (n,)
    attn = {name: draw(lead + shape, shape[0]) for name, shape in mla_shapes(cfg).items()}
    attn["kv_norm"] = _norm(lead, cfg.kv_lora_rank, device)
    p = {"ln1": _norm(lead, cfg.d_model, device), "attn": attn,
         "ln2": _norm(lead, cfg.d_model, device)}
    if moe:
        p["moe"] = init_deepseek_moe(generator, cfg, draw, device, lead)
    else:
        d, f = cfg.d_model, cfg.d_ff
        p["mlp"] = {"gate": draw(lead + (d, f), d), "up": draw(lead + (d, f), d),
                    "down": draw(lead + (f, d), f)}
    return p


def init_deepseek_v3(generator: torch.Generator, cfg: DeepSeekV3Config, device=None) -> Params:
    """Params drawn on ``device`` from ``generator`` (which lives there)."""
    draw = _drawer(generator, cfg, device)
    k = cfg.first_k_dense_replace
    return {
        "embed": {"table": draw((cfg.vocab_size, cfg.d_model), cfg.d_model)},
        "dense": _init_layers(generator, cfg, draw, device, k, moe=False),
        "moe": _init_layers(generator, cfg, draw, device, cfg.num_layers - k, moe=True),
        "ln_f": _norm((), cfg.d_model, device),
        "unembed": {"w": draw((cfg.d_model, cfg.vocab_size), cfg.d_model)},
    }


def deepseek_v3_specs(cfg: DeepSeekV3Config) -> Params:
    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return (None,) + tree

    norm = {"scale": (None,)}
    layer = {"ln1": norm, "attn": mla_specs(), "ln2": norm}
    return {
        "embed": {"table": ("tp", "fsdp")},
        "dense": stacked({**layer, "mlp": {"gate": ("fsdp", "tp"), "up": ("fsdp", "tp"),
                                           "down": ("tp", "fsdp")}}),
        "moe": stacked({**layer, "moe": deepseek_moe_specs()}),
        "ln_f": norm,
        "unembed": {"w": ("fsdp", "tp")},
    }


def _layers(params: Params, cfg: DeepSeekV3Config):
    """(layer params, is MoE) of every layer in order."""
    k = cfg.first_k_dense_replace
    return ([(lp, False) for lp in _unstack(params["dense"], k)]
            + [(lp, True) for lp in _unstack(params["moe"], cfg.num_layers - k)])


def _ffn(lp: Params, x: torch.Tensor, cfg: DeepSeekV3Config, moe: bool,
         grouped: bool) -> torch.Tensor:
    """The layer's feed-forward on the normed stream x (f32): the router
    reads x, the products its compute-dtype rounding."""
    if moe:
        return apply_deepseek_moe(lp["moe"], x, cfg, grouped=grouped)
    return swiglu_ffn(_compute(x, cfg), lp["mlp"])


def _rms(p: Params, h: torch.Tensor, cfg: DeepSeekV3Config) -> torch.Tensor:
    """RMSNorm of the f32 stream (one fused kernel where the device has one)."""
    return F.rms_norm(h, (h.shape[-1],), p["scale"], cfg.rms_norm_eps)


def _compute(x: torch.Tensor, cfg: DeepSeekV3Config) -> torch.Tensor:
    return x.to(getattr(torch, cfg.compute_dtype))


def prefill(params: Params, batch: dict, cfg: DeepSeekV3Config, **_) -> tuple[torch.Tensor, Params]:
    """tokens (B, S) -> (the last position's logits (B, 1, V), {"latent":
    (L, B, S, C + rope)}).  The transformer's ``kv_chunk``/``q_chunks``
    are taken and ignored: the attention is one causal call a layer."""
    tokens = batch["tokens"]
    h = embed_tokens(params["embed"], tokens, torch.float32)
    table = rope_table(torch.arange(tokens.shape[1], device=tokens.device), cfg)
    latents = []
    for lp, moe in _layers(params, cfg):
        a, latent = mla_prefill(lp["attn"], _compute(_rms(lp["ln1"], h, cfg), cfg), cfg, table)
        h = h + a
        h = h + _ffn(lp, _rms(lp["ln2"], h, cfg), cfg, moe, grouped=True)
        latents.append(latent)
    h = _compute(_rms(params["ln_f"], h[:, -1:], cfg), cfg)
    return unembed_logits(params["unembed"]["w"], h), {"latent": torch.stack(latents)}


def decode_step(params: Params, token: torch.Tensor, cache: Params, cache_len: torch.Tensor,
                cfg: DeepSeekV3Config) -> tuple[torch.Tensor, Params]:
    """token (B, 1) -> (logits (B, 1, V), cache), each layer's latent of the
    token written into ``cache`` at ``cache_len`` in place."""
    h = embed_tokens(params["embed"], token, torch.float32)
    cache_len = torch.as_tensor(cache_len, device=token.device)
    step = decode_step_tables(cache_len, cache["latent"].shape[2], cfg)
    for i, (lp, moe) in enumerate(_layers(params, cfg)):
        x = _compute(_rms(lp["ln1"], h, cfg), cfg)
        h = h + mla_decode(lp["attn"], x, cache["latent"][i], cache_len, step, cfg)
        h = h + _ffn(lp, _rms(lp["ln2"], h, cfg), cfg, moe, grouped=False)
    h = _compute(_rms(params["ln_f"], h, cfg), cfg)
    return _head(params["unembed"]["w"], h), cache


def _head(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A decode step's logits (B, 1, V) = h (B, 1, D) @ w (D, V), a product
    a half of the vocabulary: as one product at a few rows cuBLAS puts a
    memset before it in a captured graph, a node a profiler's trace of the
    graph can lose."""
    w = w.to(h.dtype)
    return torch.cat([h @ part for part in w.chunk(2, dim=1)], dim=-1)


def init_latent_cache(cfg: DeepSeekV3Config, batch: int, max_len: int, device=None) -> Params:
    """A zeroed latent cache {"latent": (L, B, max_len, C + rope)} in the
    compute dtype."""
    shape = (cfg.num_layers, batch, max_len, cfg.latent_dim)
    return {"latent": torch.zeros(shape, dtype=getattr(torch, cfg.compute_dtype), device=device)}


def latent_cache_specs() -> Params:
    return {"latent": (None, "batch", "tp", None)}


def stitch_latent_cache(cfg: DeepSeekV3Config, prefill_cache: Params, max_len: int) -> Params:
    """A latent cache of ``max_len`` positions holding the prefill's latents
    (L, B, S, C + rope) at positions [0, S); decoding starts at S."""
    latent = prefill_cache["latent"]
    covered = latent.shape[2]
    if max_len < covered:
        raise ValueError(f"a decode cache of {max_len} positions cannot hold the "
                         f"{covered} the prefill covered")
    cache = init_latent_cache(cfg, latent.shape[1], max_len, device=latent.device)
    cache["latent"].narrow(2, 0, covered).copy_(latent)
    return cache
