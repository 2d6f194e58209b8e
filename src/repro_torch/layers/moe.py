"""Mixture-of-Experts with top-k routing.

Counterpart of ``repro/layers/moe.py``.  Two interchangeable
implementations (``cfg.moe.impl``):

* ``scatter`` — production path: capacity-bounded token dispatch into an
  (E, C, D) buffer, batched expert products, gather-combine.  Dropped
  tokens (over capacity) contribute zero, matching Switch/GShard
  semantics [arXiv:2101.03961, arXiv:2006.16668].
* ``dense`` — oracle: every expert runs on every token, outputs weighted by
  the (renormalised) top-k gates.  O(E) FLOPs — tests only, and the
  correctness reference for the scatter path when nothing is dropped.

``ep_a2a`` is the reference's expert-parallel path over a mesh
(``apply_moe_ep``); without a mesh it is ``apply_moe``, as there, and a
mesh raises: its shard_map and all_to_all come with the sharded step
(ROADMAP.md, queue 1, item 11g-2).

Returns (y, aux_loss): aux is the Switch load-balance loss
``E * sum_e f_e * P_e`` (fraction dispatched x mean router prob).

Routing is discrete: one ulp in a router probability can swap one of a
token's experts and move the capacity slot of every later token routed to
it.  So the router's product is taken in f64 and rounded to f32: the
probabilities do not depend on the order of accumulation, and no TF32
setting of the process reaches them (PyTorch raises on reading its TF32
flags once a process has set them through both of its APIs, so a layer
cannot switch TF32 off for one product).  A slot is the count of earlier
entries routed to the same expert in flat (token-major, choice-minor)
order, from an exclusive cumsum; ``torch.topk`` returns the choices in
descending order, as ``lax.top_k`` does.  Nothing here syncs with the
host (the capacity is a Python int from static shapes, ``one_hot`` is
given its class count, no boolean indexing), so a decode step through
this layer captures into one CUDA graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.core import ModelConfig
from repro_torch.utils import Params, truncated_normal_init

SHARDING_ITEM = "ROADMAP.md, queue 1, item 11g-2 (the sharded step)"


def init_moe(generator: torch.Generator, cfg: ModelConfig, device=None,
             lead: tuple[int, ...] = ()) -> Params:
    """``lead`` prepends dims to every leaf (a stack of layers, drawn at once)."""
    moe = cfg.moe
    e, d, f = moe.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": truncated_normal_init(lead + (d, e), d, generator, device),
        "gate": truncated_normal_init(lead + (e, d, f), d, generator, device),
        "up": truncated_normal_init(lead + (e, d, f), d, generator, device),
        "down": truncated_normal_init(lead + (e, f, d), f, generator, device),
    }


def moe_specs(cfg: ModelConfig) -> Params:
    return {
        "router": (None, None),
        "gate": ("expert", "fsdp", None),
        "up": ("expert", "fsdp", None),
        "down": ("expert", None, "fsdp"),
    }


def _router(params: Params, x: torch.Tensor, top_k: int):
    """x: (N, D) -> (weights (N,k) f32, indices (N,k) int64, probs (N,E) f32)."""
    logits = (x.double() @ params["router"].double()).float()
    probs = torch.softmax(logits, dim=-1)
    weights, indices = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    return weights, indices, probs


def _aux_loss(probs: torch.Tensor, indices: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch/GShard load-balance loss, normalised so that perfectly uniform
    dispatch + uniform router probs give exactly 1.0 (f_e is the fraction of
    the N*k dispatch slots assigned to expert e)."""
    dispatch = F.one_hot(indices.long(), num_experts).float()      # (N,k,E)
    k = indices.shape[-1]
    frac_dispatched = dispatch.sum(dim=1).mean(dim=0) / k           # (E,)
    mean_prob = probs.mean(dim=0)                                   # (E,)
    return num_experts * torch.sum(frac_dispatched * mean_prob)


def _expert_ffn(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Batched per-expert SwiGLU: h (E, C, D) -> (E, C, D), the weights
    cast to h's dtype at use, as in the reference."""
    dt = h.dtype
    g = torch.bmm(h, params["gate"].to(dt))
    u = torch.bmm(h, params["up"].to(dt))
    return torch.bmm(F.silu(g) * u, params["down"].to(dt))


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    moe = cfg.moe
    c = math.ceil(num_tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 for layout friendliness


def apply_moe(params: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux loss (scalar f32)."""
    moe = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, indices, probs = _router(params, xf, moe.top_k)
    aux = _aux_loss(probs, indices, moe.num_experts)
    combine = _dense_combine if moe.impl == "dense" else _scatter_combine
    return combine(params, xf, weights, indices, cfg).reshape(b, s, d), aux


def apply_moe_ep(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: without a mesh, :func:`apply_moe` (the
    reference's fallback when no mesh is active)."""
    if mesh is not None:
        raise NotImplementedError(
            f"expert-parallel MoE over a mesh is not ported yet: {SHARDING_ITEM}")
    return apply_moe(params, x, cfg)


def _dense_combine(params, xf, weights, indices, cfg: ModelConfig) -> torch.Tensor:
    moe = cfg.moe
    n, d = xf.shape
    # every expert on every token: (E, N, D)
    out = _expert_ffn(params, xf.expand(moe.num_experts, n, d), cfg)
    gates = torch.zeros((n, moe.num_experts), dtype=torch.float32, device=xf.device)
    gates = gates.scatter_add(1, indices.long(), weights.float())
    y = torch.einsum("end,ne->nd", out.float(), gates)
    return y.to(xf.dtype)


def _scatter_combine(params, xf, weights, indices, cfg: ModelConfig) -> torch.Tensor:
    moe = cfg.moe
    n, d = xf.shape
    e, k = moe.num_experts, moe.top_k
    cap = capacity(n, cfg)

    # position of each (token, choice) within its expert, in flat order: the
    # exclusive cumsum of the one-hot down the entries.  It is laid out
    # expert-major, (E, N*k), and scanned as one flat array, each row then
    # less the entries of the rows before it: a scan down (N*k, E) would run
    # as E serial scans (785 of a 1,535 ms prefill on an H100).
    flat_e = indices.reshape(-1).long()                                  # (N*k,)
    experts = torch.arange(e, device=flat_e.device)[:, None]
    onehot = (experts == flat_e).to(torch.int32)                         # (E, N*k)
    seen = torch.cumsum(onehot.reshape(-1), dim=0, dtype=torch.int32).reshape(e, n * k)
    before = seen[:, -1:] - onehot.sum(dim=1, keepdim=True, dtype=torch.int32)
    pos = seen - before - onehot                                         # exclusive, per expert
    flat_p = pos.gather(0, flat_e[None, :])[0]                           # (N*k,)
    dropped = flat_p >= cap
    flat_p = torch.where(dropped, cap, flat_p)                           # park dropped in slot `cap`
    slot = flat_e * (cap + 1) + flat_p                                   # row of (E*(cap+1), D)

    # dispatch: (E, cap+1, D) buffer; slot `cap` is the drop bin.  Every
    # other slot receives one row, so adding onto zeros writes it exactly.
    upd = xf[:, None, :].expand(n, k, d).reshape(n * k, d)               # (N*k, D)
    buf = xf.new_zeros((e * (cap + 1), d)).index_add(0, slot, upd)

    out = _expert_ffn(params, buf.view(e, cap + 1, d)[:, :cap], cfg)    # (E, cap, D)
    out = torch.cat([out, out.new_zeros((e, 1, d))], dim=1)

    # combine: gather each (token, choice) result, weight, sum over k
    gathered = out.reshape(e * (cap + 1), d)[slot].reshape(n, k, d)      # dropped -> zeros
    w = torch.where(dropped.reshape(n, k), 0.0, weights).float()
    y = torch.einsum("nkd,nk->nd", gathered.float(), w)
    return y.to(xf.dtype)
