"""RWKV-6 "Finch" block [arXiv:2404.05892]: time-mix with data-dependent
per-channel decay + squared-ReLU channel-mix.

Counterpart of ``repro/layers/rwkv.py``.  The WKV recurrence per head
(state S in R^{dk x dv}):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (diag(u) k_t^T v_t + S_{t-1})

with w_t = exp(-exp(w_base + lora_w(x_t))).  This is K3's function, so the
exact scan (``scan_impl="steps"``, :func:`wkv_scan`) and the decode step
(:func:`wkv_step`, the scan at T=1) go through ``ops.wkv6_op``: one K3
launch per call on CUDA tensors (hd in ``kernels.wkv6.HEAD_DIMS``; any
other raises there), its plain step loop on CPU tensors.  Under autograd
the scan is :class:`WKV6`, whose backward computes the recurrence's
adjoint chunk by chunk in plain PyTorch from states K3 rebuilds.
``scan_impl="chunked"`` (:func:`wkv_scan_chunked`) clamps the decay to
w >= exp(-4), a different function: it stays plain PyTorch and never
reaches K3.

Dtypes as in the reference: the token shift mixes in the compute dtype,
the decay LoRA runs in f32, r, k and v enter the scan in the compute dtype
(K3 takes bf16 or f32 streams with f32 w, u and state), y and the state
come out in f32, the per-head group norm runs on the f32 y, and y is cast
back before the gate.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.config.core import ModelConfig
from repro_torch.kernels.ops import wkv6_op
from repro_torch.layers.linear import apply_linear, init_linear, linear_specs
from repro_torch.layers.norms import apply_norm, init_norm, norm_specs
from repro_torch.utils import Params, truncated_normal_init


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv.head_dim
    if cfg.d_model % hd:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the head dim {hd}")
    return cfg.d_model // hd, hd


def init_time_mix(generator: torch.Generator, cfg: ModelConfig, device=None,
                  lead: tuple[int, ...] = ()) -> Params:
    """``lead`` prepends dims to every leaf (a stack of layers, drawn at once)."""
    d = cfg.d_model
    h, hd = _heads(cfg)
    r = cfg.rwkv.decay_lora
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "r": init_linear(generator, d, d, device=device, lead=lead),
        "k": init_linear(generator, d, d, device=device, lead=lead),
        "v": init_linear(generator, d, d, device=device, lead=lead),
        "g": init_linear(generator, d, d, device=device, lead=lead),
        "o": init_linear(generator, d, d, device=device, lead=lead),
        # data-dependent decay LoRA: w_t = wbase + tanh(x W1) W2
        "w1": truncated_normal_init(lead + (d, r), d, generator, device),
        "w2": truncated_normal_init(lead + (r, d), r, generator, device),
        "wbase": torch.full(lead + (d,), -6.0, **f32),   # exp(-exp(-6)) ~ slow decay
        "u": truncated_normal_init(lead + (h, hd), hd, generator, device),   # bonus
        "mix": torch.full(lead + (5, d), 0.5, **f32),     # token-shift mixes (r,k,v,g,w)
        "gn": init_norm("layernorm", hd, device, lead),    # per-head group norm
    }


def time_mix_specs(cfg: ModelConfig) -> Params:
    return {
        "r": linear_specs("fsdp", "tp"),
        "k": linear_specs("fsdp", "tp"),
        "v": linear_specs("fsdp", "tp"),
        "g": linear_specs("fsdp", "tp"),
        "o": linear_specs("tp", "fsdp"),
        "w1": ("fsdp", None),
        "w2": (None, "tp"),
        "wbase": ("tp",),
        "u": ("tp", None),
        "mix": (None, "tp"),
        "gn": norm_specs("layernorm"),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Shift sequence right by one; x_prev fills position 0. x: (B,S,D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _projections(params: Params, x: torch.Tensor, shifted: torch.Tensor, cfg: ModelConfig):
    """Compute r,k,v,g,w streams with per-stream token-shift mixing."""
    mix = params["mix"].to(x.dtype)  # (5, D)
    delta = shifted - x
    xr, xk, xv, xg, xw = (x + m * delta for m in mix)
    h, hd = _heads(cfg)

    def split_heads(t):
        return t.reshape(t.shape[0], t.shape[1], h, hd)

    r = split_heads(apply_linear(params["r"], xr))
    k = split_heads(apply_linear(params["k"], xk))
    v = split_heads(apply_linear(params["v"], xv))
    g = F.silu(apply_linear(params["g"], xg))
    w_log = params["wbase"].float() + (
        torch.tanh(xw.float() @ params["w1"].float()) @ params["w2"].float())
    w = split_heads(torch.exp(-torch.exp(w_log)))  # in (0,1), per channel; f32
    return r, k, v, g, w


def _chunk(t: torch.Tensor, t0: int, c: int) -> torch.Tensor:
    """Timesteps [t0, t0 + c) of a (B, T, ...) stream, contiguous (K3's layout)."""
    return t[:, t0:t0 + c].contiguous()


def _chunk_backward(r, k, v, w, u, s_in, dy, ds_out):
    """The WKV recurrence's adjoint over one chunk of c steps, in f32 plain
    PyTorch: r, k, v, w, dy (B, c, H, hd), s_in the state before the chunk,
    ds_out dL/dS after it.  Returns ((dr, dk, dv, dw) in the inputs' dtypes,
    du, dL/ds_in).  Only the two state recurrences run step by step (one
    ``addcmul`` a step each way); every other term is one batched op over
    the chunk:

        S_t = w_t * S_{t-1} + k_t v_t^T            y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
        dS_{t-1} = w_t * dS_t + r_t dy_t^T        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t = dS_t v_t + r_t u (v_t . dy_t)      dv_t = dS_t^T k_t + (r_t . u k_t) dy_t
        dw_t = rowsum(dS_t * S_{t-1})             du = sum_t r_t k_t (v_t . dy_t)
    """
    rf, kf, vf, wf, dyf = (t.float().transpose(0, 1) for t in (r, k, v, w, dy))  # (c, B, H, hd)
    c = rf.shape[0]
    prev = torch.empty((c,) + tuple(s_in.shape), dtype=torch.float32, device=s_in.device)
    prev[0] = s_in                                                   # prev[t] = S_{t-1}
    kv = kf[..., :, None] * vf[..., None, :]
    for t in range(c - 1):
        torch.addcmul(kv[t], wf[t, ..., None], prev[t], out=prev[t + 1])
    del kv
    rdy = rf[..., :, None] * dyf[..., None, :]
    dstate = torch.empty_like(prev)                                  # dstate[t] = dL/dS_t
    dstate[c - 1] = ds_out
    for t in range(c - 1, 0, -1):
        torch.addcmul(rdy[t], wf[t, ..., None], dstate[t], out=dstate[t - 1])
    ds_in = torch.addcmul(rdy[0], wf[0, ..., None], dstate[0])
    del rdy
    uf = u.float()
    vdy = (vf * dyf).sum(-1, keepdim=True)                          # v_t . dy_t
    dr = torch.einsum("tbhij,tbhj->tbhi", prev, dyf) + uf * kf * vdy
    dk = torch.einsum("tbhij,tbhj->tbhi", dstate, vf) + rf * uf * vdy
    dv = torch.einsum("tbhij,tbhi->tbhj", dstate, kf) + (rf * uf * kf).sum(-1, keepdim=True) * dyf
    dw = (dstate * prev).sum(-1)
    du = (rf * kf * vdy).sum((0, 1))
    grads = tuple(g.transpose(0, 1).to(t.dtype) for g, t in zip((dr, dk, dv, dw), (r, k, v, w)))
    return grads, du, ds_in


class WKV6(torch.autograd.Function):
    """K3's function with a gradient: ``WKV6.apply(r, k, v, w, u, s0, chunk)
    -> (y, S_T)``.

    Forward: one ``wkv6_op`` over the whole sequence (one K3 launch on
    CUDA), nothing saved beyond the inputs.  Backward: the state at the
    start of every ``chunk``-step chunk after the first is rebuilt by one
    ``wkv6_op`` per chunk (chunks chain), ceil(T / chunk) - 1 launches;
    then the chunks are walked in reverse, each one's adjoint computed by
    :func:`_chunk_backward` from its start state and the dS carried from
    the chunk after it.  So the backward holds one chunk's states at a
    time, never T of them.  The CPU runs the same code with the plain
    version in place of K3."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        y, s_t = wkv6_op(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.chunk = chunk
        return y, s_t

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds):
        r, k, v, w, u, s0 = ctx.saved_tensors
        c = ctx.chunk
        starts = range(0, r.shape[1], c)
        states = [s0]
        for t0 in starts[:-1]:
            states.append(wkv6_op(*(_chunk(t, t0, c) for t in (r, k, v, w)), u, states[-1])[1])
        grads = [torch.empty_like(t) for t in (r, k, v, w)]
        du = torch.zeros_like(u)
        for i in reversed(range(len(starts))):
            sl = slice(starts[i], starts[i] + c)
            got, du_i, ds = _chunk_backward(*(t[:, sl] for t in (r, k, v, w)), u, states[i],
                                            dy[:, sl], ds)
            for buf, g in zip(grads, got):
                buf[:, sl] = g
            du += du_i
        return (*grads, du, ds if ctx.needs_input_grad[5] else None, None)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor, chunk: int = 64):
    """Run the WKV recurrence over a full sequence.

    r,k,v: (B,S,H,hd) in one dtype (f32 or bf16, passed to K3 uncast); w:
    (B,S,H,hd) decay in (0,1); u: (H,hd) bonus; state: (B,H,hd,hd).
    Returns (y (B,S,H,hd) f32, final state f32).  The reference pads S to a
    multiple of ``chunk`` (w = 1, k = v = 0: the result is unchanged) for
    its nested scan; here ``chunk`` is only the backward's chunk length."""
    return WKV6.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                      w.float().contiguous(), u.float().contiguous(),
                      state.float().contiguous(), chunk)


def wkv_scan_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, state: torch.Tensor, sub_chunk: int = 16,
                     w_min_log: float = -4.0):
    """Chunked MATMUL form of the WKV recurrence (GLA-style [arXiv:2312.06635]).

    Replaces T sequential per-step outer products with T/16 dense tiles:

        scores[t,s] = (r_t * Q_{t-1}) . (k_s / Q_s)   (strictly lower tri)
        y = scores @ V + (r * Q_prev) @ S_in + diag bonus
        S_out = diag(Q_C) S_in + (k * (Q_C / Q_s))^T V

    where Q = intra-tile cumprod(w).  The 1/Q factor is bounded by clamping
    the per-step decay to w >= exp(w_min_log); with tiles of 16 the largest
    exponent is 16*|w_min_log| = 64 < log(f32max) ~ 88.  The clamp makes
    this another function than K3's, so it runs in plain PyTorch ops
    (differentiable as written), on either device.
    """
    b, s, h, hd = r.shape
    c = min(sub_chunk, s)
    pad = (-s) % c
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = (s + pad) // c

    def chunks(t):  # (B, S, H, hd) -> (n, B, H, c, hd)
        return t.reshape(b, n, c, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(chunks, (r, k, v, w))
    u_f = u.float()[None, :, None, :]                                  # (1, H, 1, hd)
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32, device=r.device), diagonal=-1)
    s_in = state.float()
    ys = []
    for i in range(n):
        r_f, k_f, v_f = rc[i].float(), kc[i].float(), vc[i].float()   # (B, H, c, hd)
        w_f = torch.clamp(wc[i].float(), math.exp(w_min_log), 1.0)
        logq = torch.cumsum(torch.log(w_f), dim=2)                     # <= 0
        q = torch.exp(logq)
        q_prev = torch.exp(logq - torch.log(w_f))                      # Q_{t-1} = Q_t / w_t
        r_dec = r_f * q_prev                                           # r_t * Q_{t-1}
        k_dec = k_f * torch.exp(-logq)                                 # k_s / Q_s (bounded)
        scores = torch.einsum("bhtd,bhsd->bhts", r_dec, k_dec) * tri
        y = torch.einsum("bhts,bhsv->bhtv", scores, v_f)              # intra-tile history
        y = y + torch.einsum("bhtk,bhkv->bhtv", r_dec, s_in)          # carried state
        y = y + torch.sum(r_f * u_f * k_f, dim=-1, keepdim=True) * v_f  # bonus
        k_tail = k_f * torch.exp(logq[:, :, -1:, :] - logq)           # k_s * Q_C/Q_s <= k_s
        s_in = q[:, :, -1:, :].transpose(2, 3) * s_in + torch.einsum(
            "bhsk,bhsv->bhkv", k_tail, v_f)
        ys.append(y)
    # (n, B, H, c, hd) -> (B, n*c, H, hd)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, n * c, h, hd)[:, :s]
    return y, s_in


def wkv_step(r, k, v, w, u, state):
    """Single decode step: r,k,v,w (B,H,hd); state (B,H,hd,hd) f32.  The
    scan at T=1: one K3 launch on CUDA."""
    y, state = wkv_scan(r[:, None], k[:, None], v[:, None], w[:, None], u, state)
    return y[:, 0], state


def apply_time_mix(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   x_prev: torch.Tensor | None = None, state: torch.Tensor | None = None,
                   chunk: int = 64):
    """Sequence form. x: (B,S,D).  Returns (y, (last_x, final_state))."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    shifted = _token_shift(x, x_prev)
    r, k, v, g, w = _projections(params, x, shifted, cfg)
    if cfg.rwkv.scan_impl == "chunked":
        y, state = wkv_scan_chunked(r, k, v, w, params["u"], state)
    else:
        y, state = wkv_scan(r, k, v, w, params["u"], state, chunk=chunk)
    y = apply_norm(params["gn"], y, "layernorm")  # per-head norm
    y = y.reshape(b, s, d).to(x.dtype) * g
    return apply_linear(params["o"], y), (x[:, -1, :], state)


def apply_time_mix_step(params: Params, x: torch.Tensor, cfg: ModelConfig,
                        x_prev: torch.Tensor, state: torch.Tensor):
    """Decode step. x: (B, D).  Returns (y (B,D), (x, new_state))."""
    b, d = x.shape
    r, k, v, g, w = _projections(params, x[:, None, :], x_prev[:, None, :], cfg)
    y, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], params["u"], state)
    y = apply_norm(params["gn"], y, "layernorm")  # (B,H,hd), per-head norm
    y = y.reshape(b, d).to(x.dtype) * g[:, 0]
    return apply_linear(params["o"], y), (x, state)


def init_channel_mix(generator: torch.Generator, cfg: ModelConfig, device=None,
                     lead: tuple[int, ...] = ()) -> Params:
    return {
        "up": init_linear(generator, cfg.d_model, cfg.d_ff, device=device, lead=lead),
        "down": init_linear(generator, cfg.d_ff, cfg.d_model, device=device, lead=lead),
        "recv": init_linear(generator, cfg.d_model, cfg.d_model, device=device, lead=lead),
        "mix": torch.full(lead + (2, cfg.d_model), 0.5, dtype=torch.float32, device=device),
    }


def channel_mix_specs(cfg: ModelConfig) -> Params:
    return {
        "up": linear_specs("fsdp", "tp"),
        "down": linear_specs("tp", "fsdp"),
        "recv": linear_specs("fsdp", "tp"),
        "mix": (None, "tp"),
    }


def apply_channel_mix(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      x_prev: torch.Tensor | None = None):
    """x: (B,S,D) (or (B,1,D) step).  Returns (y, last_x)."""
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype, device=x.device)
    delta = _token_shift(x, x_prev) - x
    mix = params["mix"].to(x.dtype)
    xk = x + mix[0] * delta
    xr = x + mix[1] * delta
    k = torch.square(F.relu(apply_linear(params["up"], xk)))
    kv = apply_linear(params["down"], k)
    r = torch.sigmoid(apply_linear(params["recv"], xr))
    return r * kv, x[:, -1, :]
