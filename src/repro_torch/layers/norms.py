"""Normalisation layers: RMSNorm, LayerNorm, non-parametric LN (olmo)."""
from __future__ import annotations

import torch

from repro_torch.utils import Params


def init_norm(kind: str, dim: int, device=None, lead: tuple[int, ...] = ()) -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.ones(lead + (dim,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(lead + (dim,), dtype=torch.float32, device=device),
                "bias": torch.zeros(lead + (dim,), dtype=torch.float32, device=device)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(f"unknown norm kind {kind!r}")


def norm_specs(kind: str) -> Params:
    """Logical-axis specs matching :func:`init_norm` (all replicated)."""
    if kind == "rmsnorm":
        return {"scale": (None,)}
    if kind == "layernorm":
        return {"scale": (None,), "bias": (None,)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(f"unknown norm kind {kind!r}")


def apply_norm(params: Params, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    """Normalise over the trailing dim; statistics in fp32 for stability."""
    dtype = x.dtype
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = y * params["scale"].float()
    elif kind in ("layernorm", "nonparametric_ln"):
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) / torch.sqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    return y.to(dtype)
