"""Feed-forward blocks: SwiGLU [arXiv:2002.05202], GELU, squared-ReLU."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.core import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.layers.linear import apply_linear, init_linear, linear_specs
from repro_torch.utils import Params


def init_mlp(generator: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             device=None, lead: tuple[int, ...] = ()) -> Params:
    d_ff = d_ff or cfg.d_ff
    if cfg.activation == "swiglu":
        return {
            "gate": init_linear(generator, cfg.d_model, d_ff, device=device, lead=lead),
            "up": init_linear(generator, cfg.d_model, d_ff, device=device, lead=lead),
            "down": init_linear(generator, d_ff, cfg.d_model, device=device, lead=lead),
        }
    return {
        "up": init_linear(generator, cfg.d_model, d_ff, bias=cfg.qkv_bias, device=device,
                          lead=lead),
        "down": init_linear(generator, d_ff, cfg.d_model, bias=cfg.qkv_bias, device=device,
                            lead=lead),
    }


def mlp_specs(cfg: ModelConfig) -> Params:
    if cfg.activation == "swiglu":
        return {
            "gate": linear_specs("fsdp", "tp"),
            "up": linear_specs("fsdp", "tp"),
            "down": linear_specs("tp", "fsdp"),
        }
    return {
        "up": linear_specs("fsdp", "tp", bias=cfg.qkv_bias),
        "down": linear_specs("tp", "fsdp", bias=cfg.qkv_bias),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "relu_sq":
        return torch.square(F.relu(x))
    if kind == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {kind!r}")


def apply_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (..., D) -> (..., D); hidden activations sharded over tp."""
    if cfg.activation == "swiglu":
        h = F.silu(apply_linear(params["gate"], x)) * apply_linear(params["up"], x)
    else:
        h = _act(apply_linear(params["up"], x), cfg.activation)
    h = constrain(h, ("batch",) + (None,) * (x.ndim - 2) + ("tp",))
    y = apply_linear(params["down"], h)
    return constrain(y, ("batch", "sp", None) if x.ndim == 3
                     else ("batch",) + (None,) * (x.ndim - 1))
