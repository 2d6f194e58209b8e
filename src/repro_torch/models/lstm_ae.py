"""Model functions of the paper's LSTM-AE family.

Counterpart of ``repro/models/lstm_ae.py``.  Training uses the
layer-by-layer schedule in plain PyTorch (``train_loss``; the gradient math
is schedule-independent, and autograd runs through it as the reference's
``jax.value_and_grad`` does, with no kernel on the path); serving
delegates to the engine's schedule registry (``prefill``); streaming
carries per-layer (h, c) state, one timestep through all layers per call.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.config.core import ModelConfig
from repro_torch.core.lstm import lstm_ae_sequential, lstm_cell
from repro_torch.utils import Params


def train_loss(params: Params, batch: dict, cfg: ModelConfig, **_) -> tuple[torch.Tensor, dict]:
    """batch: series (B, T, F) -> mean reconstruction MSE."""
    xs = batch["series"].transpose(0, 1)  # (T, B, F)
    recon = lstm_ae_sequential(params, xs)
    err = torch.mean(torch.square(recon.float() - xs.float()))
    return err, {"mse": err}


def prefill(params: Params, batch: dict, cfg: ModelConfig, schedule: str = "wavefront",
            **_) -> tuple[torch.Tensor, Params]:
    """Serve a batch of sequences on the named execution schedule; returns
    per-sequence reconstruction errors (the anomaly scores)."""
    # lazy import: the engine imports this module
    from repro_torch.engine.schedules import resolve_forward

    xs = batch["series"].transpose(0, 1)
    forward = resolve_forward(schedule, cfg, device=xs.device)
    recon = forward(params, xs)
    err = torch.mean(torch.square(recon.float() - xs.float()), dim=(0, 2))
    return err, {}


def init_stream_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None) -> Params:
    dev = resolve_device(device)
    sizes = cfg.lstm_ae.layer_sizes()
    return {
        "h": tuple(torch.zeros((batch, s), dtype=dtype, device=dev) for s in sizes),
        "c": tuple(torch.zeros((batch, s), dtype=torch.float32, device=dev) for s in sizes),
    }


def decode_step(params: Params, x_t: torch.Tensor, state: Params, cache_len, cfg: ModelConfig,
                pwl: bool = False) -> tuple[torch.Tensor, Params]:
    """One streaming timestep x_t (B, F) through all layers.  A single
    timestep admits no temporal parallelism (Eq 1 with T=1), so this one
    cell loop serves every schedule — ``Engine.stream`` delegates here."""
    del cache_len
    hs, cs = [], []
    cur = x_t
    for layer, h, c in zip(params["layers"], state["h"], state["c"]):
        h_new, c_new = lstm_cell(layer, cur, h, c, pwl=pwl)
        hs.append(h_new)
        cs.append(c_new)
        cur = h_new
    return cur, {"h": tuple(hs), "c": tuple(cs)}
