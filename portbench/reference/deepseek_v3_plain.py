"""The DeepSeek-V3 decoder (Moonlight-16B-A3B) in plain float32 torch: the
reference that decides a decode run's ``correct``.

It follows the published model (``config.json``, ``model_type:
deepseek_v3``) as its settings ``spec`` give it, under their published
names.  Each layer, pre-norm:

    h = h + MLA(RMSNorm(h));  h = h + FFN(RMSNorm(h))

MLA without a low-rank query, in the expanded form: q = x W_q (heads of
``qk_nope_head_dim`` + ``qk_rope_head_dim``); [c, k_pe] = x W_kva, c
RMSNormed; each head's [k_nope, v] = c W_kvb; the rope halves of q and of
the one shared k_pe rotated by position; scores (q_nope . k_nope + q_pe .
k_pe) / sqrt(qk), causal, softmax, the weighted sum of v, then W_o.  The
FFN of the first ``first_k_dense_replace`` layers is a SwiGLU; of the rest,
the routed experts plus the shared ones: scores s = sigmoid(x W_r), the
experts are the top ``num_experts_per_tok`` of s + b (b the correction
bias, which only chooses), weighed by their s over the chosen s' sum
(``norm_topk_prob``) times ``routed_scaling_factor``, each expert's SwiGLU
run in an explicit loop over the experts on the tokens routed to it; the
shared experts' SwiGLU on every token.  Then the final RMSNorm and the
untied head.

Departures from the published description, each a choice the weights
cannot tell: RoPE pairs each rope dimension with the one half the width
away (the published code pairs interleaved ones, a fixed permutation of
the rope columns of W_q and W_kva); every RMSNorm, the latent's included,
takes ``rms_norm_eps``.

No cache, no kernels, no batching tricks.  ``forward(..., past=...)``
continues a forward over earlier positions from each layer's latents of
them, [RMSNorm(c), rope(k_pe)], from which it expands their keys and
values anew: causal attention reads nothing else of earlier positions, so
the numbers are one forward's over the whole sequence.  Attention runs a
session and ``block`` query rows at a time, so that a long prefix fits.

Plain float32 means no TF32: the products run with
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.allow_tf32``
False.  ``fp8=True`` is the control: every matrix product's two operands
rounded to float8 e4m3, one scale a tensor (its largest magnitude to
448), then multiplied in float32.  The weights come in the program's own
layout (``x @ W``), read raw.  This module imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """TF32 off for the block's products, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to float8 e4m3 at one scale for the tensor."""
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The products of a forward: exact float32, or each operand rounded to
    e4m3 first (the control)."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.fp8:
            a, b = to_e4m3(a), to_e4m3(b)
        return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate x (B, T, ..., d) by position (T,): dimension i paired with i + d/2."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv                                     # (T, d/2)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 3) + (d // 2,)
    cos, sin = ang.cos().view(shape), ang.sin().view(shape)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(ops: Ops, x: torch.Tensor, w: dict) -> torch.Tensor:
    """SwiGLU with ``w``'s "gate" and "up" (D, F) and "down" (F, D)."""
    return ops.mm(torch.nn.functional.silu(ops.mm(x, w["gate"])) * ops.mm(x, w["up"]), w["down"])


def attention(ops: Ops, w: dict, x: torch.Tensor, past: Optional[torch.Tensor], spec: dict,
              block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) at positions [P, P + T), P the positions ``past`` (B, P, C +
    rope) holds -> (the layer's output (B, T, D), the latents of x's positions
    (B, T, C + rope))."""
    b, t, _ = x.shape
    h, nope, rd, vd = (spec["num_attention_heads"], spec["qk_nope_head_dim"],
                       spec["qk_rope_head_dim"], spec["v_head_dim"])
    c_dim, qk = spec["kv_lora_rank"], nope + rd
    p0 = 0 if past is None else past.shape[1]
    positions = torch.arange(p0, p0 + t, device=x.device)
    q = ops.mm(x, w["wq"]).view(b, t, h, qk)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], positions, spec["rope_theta"])], dim=-1)
    kva = ops.mm(x, w["wkv_a"])
    c = rms_norm(kva[..., :c_dim], w["kv_norm"]["scale"], spec["rms_norm_eps"])
    k_pe = rope(kva[..., c_dim:], positions, spec["rope_theta"])
    latent = torch.cat([c, k_pe], dim=-1)
    every = latent if past is None else torch.cat([past, latent], dim=1)      # (B, P + T, C + rope)
    out = torch.empty(b, t, h, vd, dtype=torch.float32, device=x.device)
    for s in range(b):
        kv = ops.mm(every[s, :, :c_dim], w["wkv_b"]).view(-1, h, nope + vd)   # (P + T, H, nope + v)
        k = torch.cat([kv[..., :nope], every[s, :, None, c_dim:].expand(-1, h, rd)], dim=-1)
        k, v = k.transpose(0, 1), kv[..., nope:].transpose(0, 1)              # (H, P + T, .)
        for r in range(0, t, block):
            qb = q[s, r:r + block].transpose(0, 1)                             # (H, rows, qk)
            scores = ops.mm(qb, k.transpose(1, 2)) / qk ** 0.5                 # (H, rows, P + T)
            rows = p0 + torch.arange(r, min(r + block, t), device=x.device)
            keys = torch.arange(p0 + t, device=x.device)
            scores = scores.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
            out[s, r:r + block] = ops.mm(torch.softmax(scores, dim=-1), v).transpose(0, 1)
    return ops.mm(out.reshape(b, t, h * vd), w["wo"]), latent


def moe(ops: Ops, w: dict, x: torch.Tensor, spec: dict) -> torch.Tensor:
    """The routed experts, an explicit loop over them, plus the shared ones:
    x (N, D) -> (N, D)."""
    scores = torch.sigmoid(ops.mm(x, w["router"]))
    chosen = torch.topk(scores + w["bias"].float(), spec["num_experts_per_tok"], dim=-1).indices
    weights = scores.gather(1, chosen)
    if spec["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * spec["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(spec["n_routed_experts"]):
        token, slot = (chosen == e).nonzero(as_tuple=True)
        if token.numel():
            expert = {name: w[name][e] for name in ("gate", "up", "down")}
            y.index_add_(0, token, weights[token, slot, None] * swiglu(ops, x[token], expert))
    return y + swiglu(ops, x, w["shared"])


def _layers(weights: dict, spec: dict) -> list[tuple[dict, bool]]:
    """Each layer's weights (one slice of the stacked ones) and whether it is MoE."""
    def index(tree, i):
        return {k: index(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    k = spec["first_k_dense_replace"]
    return ([(index(weights["dense"], i), False) for i in range(k)]
            + [(index(weights["moe"], i), True) for i in range(spec["num_hidden_layers"] - k)])


def forward(weights: dict, ids: torch.Tensor, spec: dict, *,
            past: Optional[list] = None, fp8: bool = False, block: int = 1024,
            logits: bool = True) -> tuple[Optional[torch.Tensor], list]:
    """ids (B, T) following the positions of ``past`` (a list of each
    layer's latents (B, P, C + rope), or None) -> (the logits of the last
    position (B, V), float32, or None without ``logits``; each layer's
    latents of ids' positions (B, T, C + rope))."""
    ops = Ops(fp8)
    eps = spec["rms_norm_eps"]
    latents = []
    with no_tf32():
        h = weights["embed"]["table"][ids].float()
        for i, (w, is_moe) in enumerate(_layers(weights, spec)):
            a, latent = attention(ops, w["attn"], rms_norm(h, w["ln1"]["scale"], eps),
                                  None if past is None else past[i], spec, block)
            h = h + a
            x = rms_norm(h, w["ln2"]["scale"], eps)
            if is_moe:
                f = moe(ops, w["moe"], x.reshape(-1, x.shape[-1]), spec).view_as(x)
            else:
                f = swiglu(ops, x, w["mlp"])
            h = h + f
            latents.append(latent)
        out = None
        if logits:
            last = rms_norm(h[:, -1], weights["ln_f"]["scale"], eps)
            out = ops.mm(last, weights["unembed"]["w"])
    return out, latents
