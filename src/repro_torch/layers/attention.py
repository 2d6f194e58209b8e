"""Grouped-query attention: prefill (memory-bounded blocked softmax),
decode (one token against a KV cache) and Whisper's cross-attention.

Counterpart of ``repro/layers/attention.py``, as plain PyTorch on tensors.
The reference attends through these jnp functions and never reaches its
Pallas flash-attention kernel, so neither does the port: no library
attention either.  Scores and the softmax are f32.  Where the reference asks
for an f32 product of compute-dtype operands (``preferred_element_type``),
the port upcasts both operands and multiplies in f32: a product of two
bf16 values is exact in f32, so the sums are those of an f32-accumulating
bf16 product.

Decode writes the new token's K/V row into the cache **in place** at
``cache_len`` (``index_copy_``), the counterpart of the reference's
``dynamic_update_slice`` on a donated buffer, and returns the same
tensors: the caller's cache changes, where the reference's caller keeps
its old cache unchanged.  ``cache_len`` is a 0-d integer tensor on the
device, never read on the host, so one captured decode step serves every
position.  Cross-attention (Whisper's) projects K/V from ``x_kv``; its
decode step passes ``update_cache=False``, which writes nothing and leaves
the token's own K/V unprojected (the reference computes them and never
reads them), and may pass ``cache_len`` as a Python int, so that a
captured step copies nothing from the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config.core import ModelConfig
from repro_torch.layers.linear import apply_linear, init_linear, linear_specs
from repro_torch.layers.rotary import apply_rope
from repro_torch.utils import Params

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg: ModelConfig, device=None,
                   lead: tuple[int, ...] = ()) -> Params:
    hd = cfg.resolved_head_dim()
    return {
        "q": init_linear(generator, cfg.d_model, cfg.num_heads * hd, bias=cfg.qkv_bias,
                         device=device, lead=lead),
        "k": init_linear(generator, cfg.d_model, cfg.num_kv_heads * hd, device=device,
                         lead=lead),
        "v": init_linear(generator, cfg.d_model, cfg.num_kv_heads * hd, bias=cfg.qkv_bias,
                         device=device, lead=lead),
        "o": init_linear(generator, cfg.num_heads * hd, cfg.d_model, bias=cfg.qkv_bias,
                         device=device, lead=lead),
    }


def attention_specs(cfg: ModelConfig) -> Params:
    return {
        "q": linear_specs("fsdp", "tp", bias=cfg.qkv_bias),
        "k": linear_specs("fsdp", "tp", bias=False),
        "v": linear_specs("fsdp", "tp", bias=cfg.qkv_bias),
        "o": linear_specs("tp", "fsdp", bias=cfg.qkv_bias),
    }


def _project_qkv(params: Params, x_q: torch.Tensor, x_kv: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    bq, sq, _ = x_q.shape
    bk, sk, _ = x_kv.shape
    q = apply_linear(params["q"], x_q).reshape(bq, sq, cfg.num_heads, hd)
    k = apply_linear(params["k"], x_kv).reshape(bk, sk, cfg.num_kv_heads, hd)
    v = apply_linear(params["v"], x_kv).reshape(bk, sk, cfg.num_kv_heads, hd)
    return q, k, v


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Broadcast kv heads to query heads: (B,S,Hkv,d) -> (B,S,Hq,d)."""
    group = num_heads // k.shape[2]
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=2)


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    kv_chunk: int = 1024,
    q_chunks: int = 1,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention, O(S*chunk) memory.

    q: (B, Sq, H, d); k/v: (B, Sk, H, d) (kv heads already expanded).
    ``q_chunks > 1`` enables the causal wedge skip (chunk i of queries only
    scans kv chunks that intersect its causal window).
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)

    if q_chunks > 1 and causal and sq == sk and q_offset == 0:
        if sq % q_chunks:
            raise ValueError(f"q_chunks={q_chunks} does not divide the sequence {sq}")
        cq = sq // q_chunks
        outs = []
        for i in range(q_chunks):
            hi = (i + 1) * cq  # causal horizon for this q chunk
            outs.append(blocked_attention(
                q[:, i * cq:hi], k[:, :hi], v[:, :hi], causal=True,
                kv_chunk=min(kv_chunk, hi), q_chunks=1, q_offset=i * cq))
        return torch.cat(outs, dim=1)

    kv_chunk = min(kv_chunk, sk)
    pad = (-sk) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = (sk + pad) // kv_chunk
    q_pos = q_offset + torch.arange(sq, device=q.device)
    qf = q.float()

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for blk in range(n_chunks):
        k_blk = k[:, blk * kv_chunk:(blk + 1) * kv_chunk]
        v_blk = v[:, blk * kv_chunk:(blk + 1) * kv_chunk]
        kv_pos = blk * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        valid = kv_pos[None, :] < sk  # mask zero padding
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(valid[None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(), v_blk.float())
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (B, Sq, H, d)


def apply_attention(
    params: Params,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    causal: bool,
    positions: Optional[torch.Tensor] = None,
    use_rope: bool = True,
    x_kv: Optional[torch.Tensor] = None,
    kv_chunk: int = 1024,
    q_chunks: int = 1,
    return_kv: bool = False,
):
    """Full-sequence attention (train / prefill). x: (B, S, D); K/V are
    projected from ``x_kv`` (B, Sk, D) when it is given (cross-attention).

    With ``return_kv`` also returns the (post-RoPE, un-expanded) K/V for KV
    cache population at prefill.
    """
    q, k, v = _project_qkv(params, x, x if x_kv is None else x_kv, cfg)
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kv = (k, v) if return_kv else None
    out = blocked_attention(q, _expand_kv(k, cfg.num_heads), _expand_kv(v, cfg.num_heads),
                            causal=causal, kv_chunk=kv_chunk, q_chunks=q_chunks)
    y = apply_linear(params["o"], out.reshape(x.shape[0], x.shape[1], -1))
    if return_kv:
        return y, kv
    return y


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> Params:
    hd = cfg.resolved_head_dim()
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_specs() -> Params:
    # batch over data, kv sequence over the model axis (flash-decode layout)
    return {"k": ("batch", "tp", None, None), "v": ("batch", "tp", None, None)}


def decode_attention(
    params: Params,
    x: torch.Tensor,
    cache: Params,
    cache_len: torch.Tensor,
    *,
    cfg: ModelConfig,
    use_rope: bool = True,
    update_cache: bool = True,
) -> tuple[torch.Tensor, Params]:
    """One-token decode: x (B, 1, D) against cache (B, S_max, Hkv, hd).

    Writes the token's K/V at ``cache_len`` into ``cache`` in place and
    returns (y, cache); with ``update_cache=False`` it writes nothing and
    attends to the cache as it is.  ``cache_len`` is a 0-d integer tensor
    or a Python int.  The softmax over the cached sequence is computed in
    fp32, masking positions > cache_len.
    """
    b, one, _ = x.shape
    if one != 1:
        raise ValueError(f"decode takes one token per row, got {one}")
    hd = cfg.resolved_head_dim()
    if not isinstance(cache_len, int):
        cache_len = torch.as_tensor(cache_len, device=x.device)
    if use_rope or update_cache:        # an int is filled on the device: no copy from the host
        pos = (torch.full((1,), cache_len, dtype=torch.long, device=x.device)
               if isinstance(cache_len, int) else cache_len.reshape(1).long())
    k_cache, v_cache = cache["k"], cache["v"]
    if update_cache:
        q, k_new, v_new = _project_qkv(params, x, x, cfg)
        if use_rope:
            k_new = apply_rope(k_new, pos, cfg.rope_theta)
        k_cache.index_copy_(1, pos, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, pos, v_new.to(v_cache.dtype))
    else:
        q = apply_linear(params["q"], x).reshape(b, 1, cfg.num_heads, hd)
    if use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)

    s_max = k_cache.shape[1]
    group = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, cfg.num_kv_heads, group, hd)  # (B, Hkv, G, d) (Sq==1 folded)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k_cache.to(q.dtype).float()) / math.sqrt(hd)
    valid = torch.arange(s_max, device=x.device)[None, :] <= cache_len  # includes the new token
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    out = out.reshape(b, 1, cfg.num_heads * hd).to(x.dtype)
    return apply_linear(params["o"], out), cache
