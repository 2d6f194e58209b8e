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

``ep_a2a`` is the reference's expert-parallel path (``apply_moe_ep``):
tokens stay on their (batch x model) shard, routing is local, and dispatch
and combine move through an all_to_all over the model (= expert) axis;
the expert weights are FSDP-sharded over "data" and gathered per layer.
Without a mesh it is ``apply_moe``, as there.  The body runs on each
rank's blocks inside ``local_map`` (the reference's ``shard_map``).  Its
collectives are autograd functions over the c10d calls, each with its
transpose written out: the all_to_all's is the reverse exchange, the
all_gather's a reduce-scatter (torch's functional
``all_to_all_single_autograd`` falls back to an all_gather and a chunk
on gloo, where c10d's ``all_to_all_single`` runs).  A sum whose result
every rank of a group then holds alike (the pmean of the routing
statistics, the replicated path's combine) passes its gradient back
unchanged, the transpose JAX gives ``psum``: each rank receives the
whole gradient of a replicated output, so summing the gradients as well
(what ``torch.distributed.nn.functional.all_reduce`` does) would count
it once per rank.

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
from repro_torch.distributed.sharding import (
    active_mesh,
    active_rules,
    axis_names,
    axis_size,
    constrain,
    gather_dim,
    lay_out,
    placements_of,
    replicate_uneven,
    replicated,
    to_placements,
)
from repro_torch.utils import Params, truncated_normal_init


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
    # experts already occupy the model axis; hidden dim stays local
    a = constrain(F.silu(g) * u, ("expert", None, None))
    return torch.bmm(a, params["down"].to(dt))


def _swiglu(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    """:func:`_expert_ffn` on local blocks (no layout pin)."""
    dt = h.dtype
    a = F.silu(torch.bmm(h, gate.to(dt))) * torch.bmm(h, up.to(dt))
    return torch.bmm(a, down.to(dt))


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    moe = cfg.moe
    c = math.ceil(num_tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 for layout friendliness


def apply_moe(params: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux loss (scalar f32)."""
    moe = cfg.moe
    b, s, d = x.shape
    # under a mesh (b, s) is flattened with only the batch sharded, and
    # unflattened so too: flattening a batch over data and a sequence over
    # the model axis makes a strided shard, each of whose redistributions
    # DTensor plans from index lists as long as the tokens
    xf = constrain(lay_out(x, ("batch", None, None)).reshape(b * s, d), ("tokens", None))
    weights, indices, probs = _router(params, xf, moe.top_k)
    aux = _aux_loss(probs, indices, moe.num_experts)
    combine = _dense_combine if moe.impl == "dense" else _scatter_combine
    y = lay_out(combine(params, xf, weights, indices, cfg), ("batch", None))
    return y.reshape(b, s, d), aux


class _SumInvariant(torch.autograd.Function):
    """Sum over ``group`` of each rank's part, which every rank then holds
    alike; the gradient, which arrives whole on each rank, passes back
    unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllToAll(torch.autograd.Function):
    """Block j of ``x``'s leading dim to rank j of ``group``, block i of
    the result from rank i; the gradient goes back by the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    torch.distributed.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order; the gradient is each rank's block of the gradients summed over
    the group (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = torch.distributed.get_world_size(group)
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        n = torch.distributed.get_world_size(ctx.group)
        gt = grad.movedim(ctx.dim, 0).contiguous()
        out = gt.new_empty((gt.shape[0] // n,) + tuple(gt.shape[1:]))
        torch.distributed.reduce_scatter_tensor(out, gt, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def _pmean(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    for ax in axes:
        t = _SumInvariant.apply(t, mesh.get_group(ax)) / axis_size(mesh, ax)
    return t


def _positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each entry's position among the entries routed to its expert, in
    flat order: the exclusive cumsum of the one-hot down the entries.  It
    is laid out expert-major, (E, N*k), and scanned as one flat array,
    each row then less the entries of the rows before it (the scan's last
    column one row up): a scan down (N*k, E) would run as E serial scans
    (785 of a 1,535 ms prefill on an H100)."""
    nk = flat_e.shape[0]
    experts = torch.arange(e, device=flat_e.device)[:, None]
    onehot = (experts == flat_e).to(torch.int32)                         # (E, N*k)
    seen = torch.cumsum(onehot.reshape(-1), dim=0, dtype=torch.int32).reshape(e, nk)
    first = torch.zeros((1, 1), dtype=seen.dtype, device=seen.device)
    before = torch.cat([first, seen[:-1, -1:]])
    pos = seen - before - onehot                                         # exclusive, per expert
    return pos.gather(0, flat_e[None, :])[0]                             # (N*k,)


def _dispatch(xf: torch.Tensor, flat_e: torch.Tensor, flat_p: torch.Tensor, e: int,
              cap: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (token, choice) row into an (E, cap+1, D) buffer at (expert,
    slot), slot ``cap`` the drop bin: (buffer, row of each entry in the
    flat (E*(cap+1), D) view).  Every other slot receives one row, so
    adding onto zeros writes it exactly.  Under a mesh whose token axes do
    not divide the tokens (128 at decode over 256 ranks), the tokens are
    gathered first: DTensor cannot flatten (token, choice) of an unevenly
    sharded token dim."""
    n, d = xf.shape
    xf = replicate_uneven(xf, 0, n)
    slot = flat_e * (cap + 1) + flat_p
    upd = xf[:, None, :].expand(n, k, d).reshape(n * k, d)               # (N*k, D)
    buf = xf.new_zeros((e * (cap + 1), d)).index_add(0, slot, upd)
    return buf.view(e, cap + 1, d), slot


def _combine(out: torch.Tensor, slot: torch.Tensor, dropped: torch.Tensor,
             weights: torch.Tensor, n: int) -> torch.Tensor:
    """Gather each (token, choice)'s expert output (E, cap, D) at its row,
    zero where dropped, and sum over the choices weighted: (N, D) f32."""
    e, cap, d = out.shape
    k = weights.shape[-1]
    out = torch.cat([out, out.new_zeros((e, 1, d))], dim=1)
    gathered = out.reshape(e * (cap + 1), d)[slot].reshape(n, k, d)      # dropped -> zeros
    w = torch.where(dropped.reshape(n, k), 0.0, weights).float()
    return torch.einsum("nkd,nk->nd", gathered.float(), w)


def _ep_layout(mesh, rules):
    """(batch axes, model axis, the weights' placements in, their grads')
    of the expert-parallel bodies: router replicated, gate/up (E, D, F) over
    (model, data, -), down (E, F, D) over (model, -, data).  A weight's
    grad is whole on its shards and a part on the mesh axes it is not
    sharded over; the router's a part everywhere."""
    from torch.distributed.tensor import Partial, Shard

    batch_axes = rules.batch if isinstance(rules.batch, tuple) else (rules.batch,)
    model_axis = rules.tp
    w_specs = ((model_axis, "data", None),) * 2 + ((model_axis, None, "data"),)
    w_in = tuple(placements_of(mesh, s) for s in w_specs)
    w_grad = tuple(tuple(p if isinstance(p, Shard) else Partial() for p in pl) for pl in w_in)
    router_grad = (Partial(),) * len(axis_names(mesh))
    return batch_axes, model_axis, (replicated(mesh),) + w_in, (router_grad,) + w_grad


def apply_moe_ep(params: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE via ``local_map`` + all_to_all.

    Layout: x (B, S, D) with B over the batch axes and S over the model
    axis (sequence-parallel residual); experts over the model axis; expert
    weights FSDP-sharded over "data" (all-gathered locally per layer).
    Without an active mesh, :func:`apply_moe`; so too for decode shapes
    (S not a multiple of the model axis), where the scatter path's small
    (E, C, D) buffer is the better trade, as in the reference."""
    from torch.distributed.tensor.experimental import local_map

    mesh = active_mesh()
    if mesh is None:
        return apply_moe(params, x, cfg)
    rules = active_rules()
    moe = cfg.moe
    batch_axes, model_axis, w_in, w_grad = _ep_layout(mesh, rules)
    n_exp_shards = axis_size(mesh, model_axis)
    if moe.num_experts % n_exp_shards:
        raise ValueError(f"{moe.num_experts} experts do not split over {n_exp_shards} "
                         f"model shards")
    e_loc = moe.num_experts // n_exp_shards
    if x.shape[1] % n_exp_shards != 0:
        return apply_moe(params, x, cfg)
    e, k = moe.num_experts, moe.top_k
    model_group, data_group = mesh.get_group(model_axis), mesh.get_group("data")

    def local_moe(router_w, gate_w, up_w, down_w, x_loc):
        # x_loc: (B_loc, S_loc, D); weights: router (D, E) replicated,
        # gate/up/down (E_loc, D_loc, F)/(E_loc, F, D_loc), fsdp-sharded
        b_loc, s_loc, d = x_loc.shape
        n_loc = b_loc * s_loc
        xf = x_loc.reshape(n_loc, d)
        weights, indices, probs = _router({"router": router_w}, xf, k)
        # aux from GLOBAL sufficient statistics (pmean the per-expert
        # fractions first; pmean of local products would differ)
        f_e = F.one_hot(indices, e).float().sum(dim=1).mean(dim=0) / k
        p_e = probs.mean(dim=0)
        f_e = _pmean(f_e, mesh, (model_axis,) + tuple(batch_axes))
        p_e = _pmean(p_e, mesh, (model_axis,) + tuple(batch_axes))
        aux = e * torch.sum(f_e * p_e)

        cap = capacity(n_loc, cfg)                       # per (source shard, expert)
        flat_e = indices.reshape(-1)
        flat_p = _positions(flat_e, e)
        dropped = flat_p >= cap
        flat_p = torch.where(dropped, cap, flat_p)
        send, slot = _dispatch(xf, flat_e, flat_p, e, cap, k)

        # exchange: expert-major blocks to their owning shard
        # (E, cap, D) -> (n_shards, E_loc, cap, D) -> a2a -> a block from every source
        send = send[:, :cap].reshape(n_exp_shards, e_loc, cap, d).contiguous()
        recv = _AllToAll.apply(send, model_group)
        recv = recv.reshape(n_exp_shards, e_loc, cap, d).transpose(0, 1)
        recv = recv.reshape(e_loc, n_exp_shards * cap, d)

        # expert FFN with fsdp all-gathered weights
        out = _swiglu(recv, _AllGather.apply(gate_w, 1, data_group),
                      _AllGather.apply(up_w, 1, data_group),
                      _AllGather.apply(down_w, 2, data_group))

        # return path: reverse the exchange
        out = out.reshape(e_loc, n_exp_shards, cap, d).transpose(0, 1).contiguous()
        back = _AllToAll.apply(out, model_group)
        y = _combine(back.reshape(e, cap, d), slot, dropped, weights, n_loc)
        return y.to(x_loc.dtype).reshape(b_loc, s_loc, d), aux

    x_pl = placements_of(mesh, (tuple(batch_axes), model_axis, None))
    fn = local_map(local_moe, out_placements=(x_pl, replicated(mesh)),
                   in_placements=w_in + (x_pl,), in_grad_placements=w_grad + (x_pl,),
                   device_mesh=mesh)
    args = [to_placements(t, mesh, pl) for t, pl in zip(
        (params["router"], params["gate"], params["up"], params["down"], x), w_in + (x_pl,))]
    return fn(*args)


def _apply_moe_ep_replicated(params, x, cfg: ModelConfig):
    """EP for token counts too small to shard over the model axis (decode):
    tokens replicated over model; each shard computes its local experts and
    the outputs sum over the model axis.  Collective = one all-reduce of
    (N, D).

    As in the reference, the measured-refuted variant (per-layer weight
    gathers and capacity padding dominate at decode token counts); decode
    takes the scatter path, and this stays test-covered reference
    material.  The model ranks hold the same routing, so its aux is their
    mean: each rank's share of the router's gradient through it is then
    1/model of the batch group's."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, rules = active_mesh(), active_rules()
    moe = cfg.moe
    batch_axes, model_axis, w_in, w_grad = _ep_layout(mesh, rules)
    n_exp_shards = axis_size(mesh, model_axis)
    e_loc = moe.num_experts // n_exp_shards
    e, k = moe.num_experts, moe.top_k
    model_group, data_group = mesh.get_group(model_axis), mesh.get_group("data")

    def local_moe(router_w, gate_w, up_w, down_w, x_loc):
        b_loc, s_loc, d = x_loc.shape
        n_loc = b_loc * s_loc
        xf = x_loc.reshape(n_loc, d)
        weights, indices, probs = _router({"router": router_w}, xf, k)
        f_e = F.one_hot(indices, e).float().sum(dim=1).mean(dim=0) / k
        p_e = probs.mean(dim=0)
        f_e = _pmean(f_e, mesh, tuple(batch_axes))
        p_e = _pmean(p_e, mesh, tuple(batch_axes))
        aux = _pmean(e * torch.sum(f_e * p_e), mesh, (model_axis,))

        sid = mesh.get_local_rank(model_axis)
        local = (indices // e_loc) == sid                      # (N, k) mine?
        local_idx = torch.where(local, indices % e_loc, e_loc)  # park others
        cap = capacity(n_loc, cfg)
        flat_e = local_idx.reshape(-1)
        flat_p = _positions(flat_e, e_loc + 1)
        dropped = (flat_p >= cap) | (flat_e == e_loc)
        flat_p = torch.where(dropped, cap, flat_p)
        flat_e = torch.where(flat_e == e_loc, 0, flat_e)
        buf, slot = _dispatch(xf, flat_e, flat_p, e_loc, cap, k)
        # a parked entry lands in expert 0's drop bin, which nothing reads

        out = _swiglu(buf[:, :cap], _AllGather.apply(gate_w, 1, data_group),
                      _AllGather.apply(up_w, 1, data_group),
                      _AllGather.apply(down_w, 2, data_group))
        y = _combine(out, slot, dropped, weights, n_loc)
        y = _SumInvariant.apply(y, model_group)                  # combine experts
        return y.to(x_loc.dtype).reshape(b_loc, s_loc, d), aux

    x_pl = placements_of(mesh, (tuple(batch_axes), None, None))
    # the tokens' gradient is a part on each model rank (its experts')
    x_grad = tuple(p if isinstance(p, Shard) else Partial() for p in x_pl)
    fn = local_map(local_moe, out_placements=(x_pl, replicated(mesh)),
                   in_placements=w_in + (x_pl,), in_grad_placements=w_grad + (x_grad,),
                   device_mesh=mesh)
    args = [to_placements(t, mesh, pl) for t, pl in zip(
        (params["router"], params["gate"], params["up"], params["down"], x), w_in + (x_pl,))]
    return fn(*args)


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

    # position of each (token, choice) within its expert, in flat order
    flat_e = indices.reshape(-1).long()                                  # (N*k,)
    # the positions count over every token: under a mesh the choices are
    # gathered first (DTensor would plan each op of the scan on a strided
    # shard of E x N*k entries, from index lists as long)
    flat_p = _positions(gather_dim(flat_e, 0), e)
    dropped = flat_p >= cap
    flat_p = torch.clamp(flat_p, max=cap)                                # park dropped in slot `cap`

    # dispatch: (E, cap+1, D) buffer; slot `cap` is the drop bin
    buf, slot = _dispatch(xf, flat_e, flat_p, e, cap, k)
    buf = constrain(buf, ("expert", None, None))
    out = _expert_ffn(params, buf[:, :cap], cfg)                         # (E, cap, D)
    # combine: gather each (token, choice) result, weight, sum over k
    y = _combine(constrain(out, ("expert", None, None)), slot, dropped, weights, n)
    return y.to(xf.dtype)


# -- DeepSeek-MoE: sigmoid scores with a correction bias, shared experts, dropless --
#
# The DeepSeek-V3 family's layer (``config/deepseek.py``), beside the softmax
# router with a capacity above, which it shares nothing with.  Each token is
# routed to exactly ``num_experts_per_tok`` of ``n_routed_experts`` and
# reaches every one of them: no capacity, no drop.  The router (f32): scores
# s = sigmoid(x W_r); the experts chosen are the top k of s + b, b the
# correction bias, which chooses and never weighs; their weights are the
# chosen s, divided by their sum (``norm_topk_prob``) and multiplied by
# ``routed_scaling_factor``.  The shared experts, one SwiGLU
# ``n_shared_experts`` times an expert's width, take every token.
#
EXPERTS_TOUCHED = "repro_torch.moe.experts_touched"   # device counter: [distinct, routings]
BIAS_STD = 0.03   # the correction bias as ``init_deepseek_moe`` draws it


def init_deepseek_moe(generator: torch.Generator, cfg, draw, device=None,
                      lead: tuple[int, ...] = ()) -> Params:
    """``draw(shape, fan_in)`` gives each weight (the model's dtype); the
    correction bias is f32, N(0, BIAS_STD^2): a trained checkpoint's is
    learned to balance the experts' load, and a zero one would leave the
    selection untested; at 0.03 a decode step of 32 tokens still touches
    ~59 of 64 experts a layer (61.3 for balanced choices, ~46 at 0.1)."""
    e, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_intermediate_size
    fs = f * cfg.n_shared_experts
    bias = torch.empty(lead + (e,), dtype=torch.float32, device=device)
    if bias.device.type != "meta":
        bias.normal_(0.0, BIAS_STD, generator=generator)
    return {
        "router": draw(lead + (d, e), d),
        "bias": bias,
        "gate": draw(lead + (e, d, f), d),
        "up": draw(lead + (e, d, f), d),
        "down": draw(lead + (e, f, d), f),
        "shared": {"gate": draw(lead + (d, fs), d), "up": draw(lead + (d, fs), d),
                   "down": draw(lead + (fs, d), fs)},
    }


def deepseek_moe_specs() -> Params:
    return {"router": (None, None), "bias": (None,),
            "gate": ("expert", "fsdp", None), "up": ("expert", "fsdp", None),
            "down": ("expert", None, "fsdp"),
            "shared": {"gate": ("fsdp", "tp"), "up": ("fsdp", "tp"), "down": ("tp", "fsdp")}}


def swiglu_ffn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """SwiGLU of x (..., D) with ``p``'s "gate" and "up" (D, F) and "down"
    (F, D), in x's dtype."""
    dt = x.dtype
    return (F.silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))) @ p["down"].to(dt)


def route_sigmoid(params: Params, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, D) -> (weights (N, k) f32, indices (N, k) int64), in f32."""
    scores = torch.sigmoid(x.float() @ params["router"].float())
    _, indices = torch.topk(scores + params["bias"].float(), cfg.num_experts_per_tok, dim=-1)
    weights = scores.gather(1, indices)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * cfg.routed_scaling_factor, indices


def _one_hot(indices: torch.Tensor, e: int) -> torch.Tensor:
    """(N, k) -> (N, k, E) bool: which expert each choice is."""
    return indices[:, :, None] == torch.arange(e, device=indices.device)


def _count_touched(chosen: torch.Tensor) -> None:
    """While the program's tracer records: add this routing's distinct
    experts (``chosen``: (N, k, E), :func:`_one_hot`) and one routing to
    :data:`EXPERTS_TOUCHED`, on the device."""
    from repro_torch.obs.trace import PROGRAM

    counter = PROGRAM.device_counter(EXPERTS_TOUCHED, 2, chosen.device)
    if counter is None:
        return
    touched = chosen.flatten(0, 1).any(dim=0).sum()
    counter.add_(torch.stack([touched, torch.ones_like(touched)]))


def _padded_experts(params: Params, xf: torch.Tensor, weights: torch.Tensor,
                    chosen: torch.Tensor) -> torch.Tensor:
    """Every expert padded to all N tokens, so nothing drops: the gate, up
    and down products of every (expert, token) batched over the experts,
    each expert's activations scaled by the token's weight for it (zero for
    the experts it did not choose), and the experts' outputs summed in f32.
    Every expert's weights are read once, as the touched ones' would be at a
    decode step's few tokens.  No host sync and no memset (each product's
    form is one cuBLAS captures without one), so a decode step captures
    whole.  (N, D) f32."""
    n, d = xf.shape
    e = params["gate"].shape[0]
    dt = xf.dtype
    x = xf.expand(e, n, d)
    a = F.silu(torch.bmm(x, params["gate"].to(dt))) * torch.bmm(x, params["up"].to(dt))  # (E, N, F)
    gates = (chosen * weights[:, :, None]).sum(dim=1)                                   # (N, E) f32
    a = a * gates.t()[:, :, None].to(dt)
    return torch.bmm(a, params["down"].to(dt)).sum(dim=0, dtype=torch.float32)


def _grouped_experts(params: Params, xf: torch.Tensor, weights: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """The (token, choice) rows sorted by expert and each expert's rows
    through its SwiGLU, a loop over the experts: each computes its own rows
    and no more.  Its row counts are read on the host (one sync), so it runs
    outside any capture (prefill).  (N, D) f32."""
    n, k = indices.shape
    e = params["gate"].shape[0]
    flat_e = indices.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    token = order // k
    counts = torch.bincount(flat_e, minlength=e).tolist()
    rows = xf[token]
    out = torch.empty_like(rows)
    at = 0
    for j, c in enumerate(counts):
        if c:
            expert = {name: params[name][j] for name in ("gate", "up", "down")}
            out[at:at + c] = swiglu_ffn(rows[at:at + c], expert)
        at += c
    w = weights.reshape(-1)[order, None]
    return torch.zeros((n, xf.shape[1]), dtype=torch.float32, device=xf.device).index_add_(
        0, token, out.float() * w)


def apply_deepseek_moe(params: Params, x: torch.Tensor, cfg, *, grouped: bool) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) in x's dtype: the routed experts' weighted
    sum plus the shared experts, dropless; the router reads x, the experts
    x in ``cfg.compute_dtype``.  ``grouped`` sorts the rows by expert
    (:func:`_grouped_experts`, prefill); else every expert is padded to the
    N tokens (:func:`_padded_experts`: at a decode step's few tokens each
    touched expert's weights are read once either way, and it captures)."""
    b, s, d = x.shape
    weights, indices = route_sigmoid(params, x.reshape(b * s, d), cfg)
    xf = x.reshape(b * s, d).to(getattr(torch, cfg.compute_dtype))
    if grouped:
        routed = _grouped_experts(params, xf, weights, indices)
        chosen = _one_hot(indices, cfg.n_routed_experts) if _counting() else None
    else:
        chosen = _one_hot(indices, cfg.n_routed_experts)
        routed = _padded_experts(params, xf, weights, chosen)
    if chosen is not None:
        _count_touched(chosen)
    return (routed + shared_experts(params, xf).float()).to(x.dtype).reshape(b, s, d)


def _counting() -> bool:
    from repro_torch.obs.trace import PROGRAM

    return PROGRAM.counting()


def shared_experts(params: Params, xf: torch.Tensor) -> torch.Tensor:
    """The shared experts on every token: xf (N, D) -> (N, D)."""
    return swiglu_ffn(xf, params["shared"])
