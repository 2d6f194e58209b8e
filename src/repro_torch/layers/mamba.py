"""Mamba selective-SSM block [arXiv:2312.00752] (Jamba's recurrent mixer).

Counterpart of ``repro/layers/mamba.py``.  State h in R^{d_inner x d_state}
per batch element:

    h_t = exp(dt_t * A) . h_{t-1} + dt_t * B_t * x_t     (A diagonal, < 0)
    y_t = C_t . h_t + D * x_t

with data-dependent (dt_t, B_t, C_t), the "selective" part.  The reference
computes the scan as a nested ``lax.scan`` and reaches no Pallas kernel, so
the port's scan is plain PyTorch too.  :func:`ssm_scan` walks the real S
steps in chunks of ``chunk``: per chunk it forms ``exp(dt * A)`` and
``(dt * B) * x`` for every step at once (elementwise, so bit-equal to
forming them a step at a time; (B, chunk, d_inner, d_state) f32 each), then
runs the recurrence one step at a time in f32 (one ``addcmul`` a step) and
reads y out of the chunk's stacked states in one product.  The reference
pads S to a multiple of its chunk with dt = 0; those steps leave h as it
is and their y is dropped, so a walk over the real steps is the same
function.  The walk is differentiable: autograd runs its backward step by
step.  The steps' slices come from one ``unbind`` of each chunk tensor,
whose backward stacks their grads once (a slice ``da[:, t]`` per step
would scatter each step's grad into a zeroed chunk-sized buffer).

Dtypes as in the reference: the projections and the causal conv in x's
dtype (every add of the conv rounds there), dt's softplus on the f32
``dt_proj`` output, B and C in f32, the scan in f32, and the gated output
back in x's dtype.  The decode form (:func:`apply_mamba_step`) writes the
new ``ssm`` and ``conv`` state into the state it is given, in place, so one
captured decode step serves every token.  ``lead`` on :func:`init_mamba`
prepends dims to every leaf (a stack of layers, drawn at once).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config.core import ModelConfig
from repro_torch.layers.linear import apply_linear, init_linear, linear_specs
from repro_torch.utils import Params, truncated_normal_init


def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, d_state, dt_rank); dt_rank defaults to ceil(d_model / 16)."""
    ssm = cfg.ssm
    return ssm.expand * cfg.d_model, ssm.d_state, ssm.dt_rank or math.ceil(cfg.d_model / 16)


def init_mamba(generator: torch.Generator, cfg: ModelConfig, device=None,
               lead: tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    d_inner, d_state, dt_rank = mamba_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.arange(1, d_state + 1, **f32).log()
    return {
        "in_x": init_linear(generator, d, d_inner, device=device, lead=lead),
        "in_z": init_linear(generator, d, d_inner, device=device, lead=lead),  # gate branch
        "conv_w": truncated_normal_init(lead + (cfg.ssm.d_conv, d_inner), cfg.ssm.d_conv,
                                        generator, device),
        "conv_b": torch.zeros(lead + (d_inner,), **f32),
        # x -> (dt_rank + 2*d_state): dt low-rank + B + C
        "x_proj": init_linear(generator, d_inner, dt_rank + 2 * d_state, device=device,
                              lead=lead),
        "dt_proj": init_linear(generator, dt_rank, d_inner, bias=True, device=device, lead=lead),
        "a_log": a.expand(lead + (d_inner, d_state)).clone(),
        "d_skip": torch.ones(lead + (d_inner,), **f32),
        "out": init_linear(generator, d_inner, d, device=device, lead=lead),
    }


def mamba_specs(cfg: ModelConfig) -> Params:
    return {
        "in_x": linear_specs("fsdp", "tp"),
        "in_z": linear_specs("fsdp", "tp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "x_proj": linear_specs("tp", None),
        "dt_proj": linear_specs(None, "tp", bias=True),
        "a_log": ("tp", None),
        "d_skip": ("tp",),
        "out": linear_specs("tp", "fsdp"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C).

    conv_state: (B, K-1, C) history for decode; returns (y, new_state), the
    new state the last K-1 inputs (before any activation).  The K shifted
    products are summed in the reference's order, each add in x's dtype."""
    k, s = w.shape[0], x.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)       # (B, S+K-1, C)
    w = w.to(x.dtype)
    y = w[0] * xp[:, :s]
    for j in range(1, k):
        y = y + w[j] * xp[:, j:j + s]
    y = y + b.to(x.dtype)
    new_state = xp[:, s:] if k > 1 else conv_state
    return y, new_state


def _ssm_inputs(params: Params, xc: torch.Tensor, cfg: ModelConfig):
    """xc: (B, S, d_inner) post-conv activations -> dt (f32), B_t, C_t (f32)."""
    _, d_state, dt_rank = mamba_dims(cfg)
    proj = apply_linear(params["x_proj"], xc)
    dt_lr, b_t, c_t = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(apply_linear(params["dt_proj"], dt_lr).float())
    return dt, b_t.float(), c_t.float()


def ssm_scan(dt, b_t, c_t, xc, a, state, chunk: int = 256):
    """Selective scan.  dt/xc: (B, S, d_inner); b_t/c_t: (B, S, d_state);
    a: (d_inner, d_state) (negative); state: (B, d_inner, d_state) f32.
    Returns (y (B, S, d_inner) f32, final state)."""
    s = xc.shape[1]
    h, ys = state, []
    for t0 in range(0, s, chunk):
        dt_c = dt[:, t0:t0 + chunk, :, None]                          # (B, L, di, 1)
        da = torch.exp(dt_c * a)                                      # (B, L, di, ds)
        db = dt_c * b_t[:, t0:t0 + chunk, None, :]
        dbx = db * xc[:, t0:t0 + chunk, :, None].float()
        hs = []
        for da_t, dbx_t in zip(da.unbind(1), dbx.unbind(1)):
            h = torch.addcmul(dbx_t, da_t, h)                          # da * h + db * x
            hs.append(h)
        ys.append(torch.einsum("blds,bls->bld", torch.stack(hs, 1), c_t[:, t0:t0 + chunk]))
    return torch.cat(ys, dim=1), h


def ssm_step(dt, b_t, c_t, xc, a, state):
    """One decode step: dt/xc (B, d_inner); b_t/c_t (B, d_state)."""
    da = torch.exp(dt[..., None] * a)
    db = dt[..., None] * b_t[:, None, :]
    state = da * state + db * xc.float()[..., None]
    return torch.einsum("bds,bs->bd", state, c_t), state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> Params:
    """Zeroed decode state: ``ssm`` (B, d_inner, d_state) f32, ``conv``
    (B, d_conv - 1, d_inner) in ``dtype``."""
    d_inner, d_state, _ = mamba_dims(cfg)
    return {
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_inner), dtype=dtype, device=device),
    }


def mamba_state_specs() -> Params:
    return {"ssm": ("batch", "tp", None), "conv": ("batch", None, "tp")}


def apply_mamba(params: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Params | None = None, chunk: int = 256):
    """Sequence form.  x: (B, S, D) -> (y, new_state {"ssm", "conv"})."""
    if state is None:
        state = init_mamba_state(cfg, x.shape[0], x.dtype, x.device)
    xz = apply_linear(params["in_x"], x)
    z = apply_linear(params["in_z"], x)
    xc, conv_state = _causal_conv(xz, params["conv_w"], params["conv_b"], state["conv"])
    xc = F.silu(xc)
    dt, b_t, c_t = _ssm_inputs(params, xc, cfg)
    a = -torch.exp(params["a_log"])
    y, ssm_state = ssm_scan(dt, b_t, c_t, xc, a, state["ssm"], chunk=chunk)
    y = (y.to(x.dtype) + params["d_skip"].to(x.dtype) * xc) * F.silu(z)
    return apply_linear(params["out"], y), {"ssm": ssm_state, "conv": conv_state}


def apply_mamba_step(params: Params, x: torch.Tensor, cfg: ModelConfig, state: Params):
    """Decode step.  x: (B, D) -> (y (B, D), state): the new ``ssm`` and
    ``conv`` are written into ``state`` in place, which is returned."""
    y, new = apply_mamba(params, x[:, None, :], cfg, state)
    for name in ("ssm", "conv"):
        state[name].copy_(new[name])
    return y[:, 0, :], state
