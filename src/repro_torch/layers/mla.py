"""Multi-head latent attention (MLA, DeepSeek-V2 [arXiv:2405.04434] §2.1),
without a low-rank query, as DeepSeek-V3 and Moonlight run it.

For a token x (D):

    q = x W_q                     H heads of qk = nope + rope: q_nope, q_pe
    [c, k_pe] = x W_kva           c: the latent (C wide), k_pe: one RoPE key
    c = RMSNorm(c)                shared by every head
    [k_nope, v] = c W_kvb         per head: nope and v wide
    score = (q_nope . k_nope + rope(q_pe) . rope(k_pe)) / sqrt(qk)

Prefill takes the expanded form: each head's K and V are built from the
latent of every position and attended to causally (``scaled_dot_product_
attention``, bf16 in and f32 inside).  Decode takes the absorbed form
(§2.1.3): W_kvb's key half is folded into the query, q_lat = q_nope
W_UK (C wide a head), so the scores are taken against the cached latents
themselves, and its value half after the weighted sum: o = (p . c) W_UV.
The cache holds each position's latent, ``[c, rope(k_pe)]``: C + rope
values a token a layer (576 at Moonlight's widths, against 16 x (192 +
128) for expanded K and V).

RoPE is the port's half-split form (``layers/rotary.py``'s, from one table
of angles a forward or a step, which its layers share); the published
code pairs interleaved dimensions, which for weights not read from the
published checkpoint is a fixed permutation of the rope columns of W_q and
W_kva.  Decode writes the token's latent at ``cache_len`` in place and
reads ``cache_len`` on the device only, so one captured step serves every
position; the scores and the weighted sum are products in the compute
dtype, the softmax is f32.  Nothing in the step is a memset or a device
copy (``torch.where``, not ``masked_fill``, which clones; the scores' product
in two halves, which cuBLAS captures without the memset it puts before the
whole): a captured graph's memset and copy nodes are what a profiler's trace
of it loses.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.layers.rotary import rope_frequencies
from repro_torch.utils import Params

NEG_INF = -1e30


def mla_shapes(cfg) -> dict[str, tuple[int, int]]:
    """(fan in, fan out) of each projection."""
    h = cfg.num_heads
    return {
        "wq": (cfg.d_model, h * cfg.qk_head_dim),
        "wkv_a": (cfg.d_model, cfg.latent_dim),
        "wkv_b": (cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "wo": (h * cfg.v_head_dim, cfg.d_model),
    }


def mla_specs() -> Params:
    return {"wq": ("fsdp", "tp"), "wkv_a": ("fsdp", None), "kv_norm": {"scale": (None,)},
            "wkv_b": (None, "tp"), "wo": ("tp", "fsdp")}


def _w(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return params[name].to(x.dtype)


def rope_table(positions: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of each position's angles (S, rope / 2), f32: made once for
    a forward and shared by its layers."""
    inv_freq = rope_frequencies(cfg.qk_rope_head_dim, cfg.rope_theta, device=positions.device)
    angles = positions.float()[:, None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, table) -> torch.Tensor:
    """``layers/rotary.py::apply_rope`` on x (B, S, [H,] rope) from a
    :func:`rope_table`: the half-split pairs rotated in f32."""
    cos, sin = table
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 3) + (cos.shape[-1],)
    cos, sin = cos.view(shape), sin.view(shape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def decode_step_tables(cache_len: torch.Tensor, s_max: int, cfg) -> dict:
    """What a decode step's layers share, made once a step: the rotation of
    the step's one position as a (rope, rope) f32 matrix R, x R =
    :func:`_rotate` (x) ([[C, S], [-S, C]], C and S the diagonals of cos and
    sin), and the cache positions attended (:func:`attended`)."""
    cos, sin = (t[0] for t in rope_table(cache_len.reshape(1), cfg))
    c, s = torch.diag(cos), torch.diag(sin)
    return {"rot": torch.cat([torch.cat([c, s], dim=1), torch.cat([-s, c], dim=1)]),
            "valid": attended(s_max, cache_len)}


def _project(params: Params, x: torch.Tensor, rotate, cfg):
    """x (B, S, D) -> q_nope (B, S, H, nope), rope(q_pe) (B, S, H, rope) and
    the latent [RMSNorm(c), rope(k_pe)] (B, S, C + rope); ``rotate`` turns
    (B, S, H + 1, rope) by position."""
    b, s, _ = x.shape
    q = (x @ _w(params, "wq", x)).view(b, s, cfg.num_heads, cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    c, k_pe = (x @ _w(params, "wkv_a", x)).split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c = F.rms_norm(c.float(), (c.shape[-1],), params["kv_norm"]["scale"], cfg.rms_norm_eps)
    # the heads' q_pe and the shared k_pe rotated in one pass
    pe = rotate(torch.cat([q_pe, k_pe[:, :, None]], dim=2))
    return q_nope, pe[:, :, :-1], torch.cat([c.to(x.dtype), pe[:, :, -1]], dim=-1)


def mla_prefill(params: Params, x: torch.Tensor, cfg,
                table) -> tuple[torch.Tensor, torch.Tensor]:
    """The expanded form over a whole sequence from position 0, causal: x
    (B, S, D) and the positions' :func:`rope_table` -> (y (B, S, D), the
    latents (B, S, C + rope) for the cache)."""
    b, s, _ = x.shape
    h, nope, vd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_pe, latent = _project(params, x, lambda pe: _rotate(pe, table), cfg)
    c, k_pe = latent.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    k_nope, v = (c @ _w(params, "wkv_b", x)).view(b, s, h, nope + vd).split([nope, vd], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, cfg.qk_rope_head_dim)], dim=-1)
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       is_causal=True, scale=1.0 / math.sqrt(cfg.qk_head_dim))
    y = o.transpose(1, 2).reshape(b, s, h * vd) @ _w(params, "wo", x)
    return y, latent


def attended(s_max: int, cache_len: torch.Tensor) -> torch.Tensor:
    """The cache positions a decode step attends to: (S_max,) bool, every
    position up to ``cache_len``, the token's own included."""
    return torch.arange(s_max, device=cache_len.device) <= cache_len


def write_latent(cache: torch.Tensor, cache_len: torch.Tensor, latent: torch.Tensor) -> None:
    """The token's latent (B, 1, C + rope) into ``cache`` (B, S_max, C + rope)
    at position ``cache_len``, in place."""
    cache.index_copy_(1, cache_len.reshape(1).long(), latent.to(cache.dtype))


def mla_decode(params: Params, x: torch.Tensor, cache: torch.Tensor,
               cache_len: torch.Tensor, step: dict, cfg) -> torch.Tensor:
    """The absorbed form for one token a row: x (B, 1, D) against ``cache``
    (B, S_max, C + rope), into which the token's latent is written at
    ``cache_len`` (a 0-d integer tensor on the device) first; ``step`` is
    its :func:`decode_step_tables`.  -> (B, 1, D)."""
    b = x.shape[0]
    h, nope, vd, lat = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    rot = step["rot"]
    q_nope, q_pe, latent = _project(params, x, lambda pe: (pe.float() @ rot).to(pe.dtype), cfg)
    write_latent(cache, cache_len, latent)
    wkv_b = _w(params, "wkv_b", x).view(lat, h, nope + vd)
    # q_nope W_UK, a product a head: (H, B, nope) @ (H, nope, C)
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), wkv_b[:, :, :nope].permute(1, 2, 0))
    q_cat = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1) / math.sqrt(cfg.qk_head_dim)
    kv = cache.to(x.dtype)
    # a product a half of the positions: as one product cuBLAS puts a memset
    # before it in a captured graph, a node a profiler's trace can lose
    scores = torch.cat([torch.bmm(q_cat, part.transpose(1, 2)) for part in kv.chunk(2, dim=1)],
                       dim=-1)
    scores = torch.where(step["valid"], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1, dtype=torch.float32).to(x.dtype)          # (B, H, S_max)
    o_lat = torch.bmm(p, kv[:, :, :lat])                                         # (B, H, C)
    # (p . c) W_UV, a product a head: (H, B, C) @ (H, C, v)
    o = torch.bmm(o_lat.transpose(0, 1), wkv_b[:, :, nope:].permute(1, 0, 2))
    return o.transpose(0, 1).reshape(b, 1, h * vd) @ _w(params, "wo", x)
