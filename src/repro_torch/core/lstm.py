"""LSTM cell / layer / autoencoder — the paper's model family (Section 2).

Gate order is (i, f, g, o) as in Figure 1 of the paper:

    i = sigmoid(Wxi x + Whi h + b)      f = sigmoid(...)
    g = tanh(...)                        o = sigmoid(...)
    c' = f*c + i*g                       h' = o * tanh(c')

The two MVMs (on x_t and on h_{t-1}) stay separable — ``MVM_X`` and
``MVM_H`` in the paper's accelerator.  ``pwl=True`` uses the paper's
piecewise-linear sigmoid/tanh.

Counterpart of ``repro/core/lstm.py``.  The cell here keeps that module's
bf16 order (weights cast to x.dtype, summed in x.dtype); the fused CUDA
cell (``kernels/lstm_cell.py``) keeps the kernel's order instead.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.config.core import ModelConfig
from repro_torch.utils import Params, resolve_device_or_meta, truncated_normal_init


def pwl_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear sigmoid (hard sigmoid), the paper's HLS approximation."""
    return torch.clamp(0.25 * x + 0.5, 0.0, 1.0)


def pwl_tanh(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear tanh (hard tanh)."""
    return torch.clamp(x, -1.0, 1.0)


def _acts(pwl: bool):
    if pwl:
        return pwl_sigmoid, pwl_tanh
    return torch.sigmoid, torch.tanh


def init_lstm_cell(generator: torch.Generator, input_size: int, hidden_size: int,
                   device=None) -> Params:
    # drawn on the CPU and moved, so a seed gives the same weights on every
    # device; on the meta device (shapes only) nothing is drawn at all
    dev = resolve_device_or_meta(device)
    draw = dev if dev.type == "meta" else None
    return {
        "wx": truncated_normal_init((input_size, 4 * hidden_size), input_size, generator,
                                    draw).to(dev),
        "wh": truncated_normal_init((hidden_size, 4 * hidden_size), hidden_size, generator,
                                    draw).to(dev),
        "b": torch.zeros((4 * hidden_size,), dtype=torch.float32, device=dev),
    }


def lstm_cell_specs() -> Params:
    return {"wx": (None, "tp"), "wh": (None, "tp"), "b": ("tp",)}


def lstm_cell(
    params: Params,
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    pwl: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One timestep.  x: (..., B, In); h, c: (..., B, H) -> (h', c').

    Leading dimensions batch over a layer stack (``wx`` (N, In, 4H),
    ``b`` (N, 1, 4H)): the wavefront schedule runs every layer in one call."""
    sig, tnh = _acts(pwl)
    gx = x @ params["wx"].to(x.dtype)          # MVM_X
    gh = h @ params["wh"].to(h.dtype)          # MVM_H
    gates = (gx + gh + params["b"].to(x.dtype)).float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = sig(f) * c.float() + sig(i) * tnh(g)
    h_new = sig(o) * tnh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_layer(
    params: Params,
    xs: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
    pwl: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Run one LSTM layer over time.  xs: (T, B, In) -> ys (T, B, H)."""
    b = xs.shape[1]
    hidden = params["wh"].shape[0]
    h = torch.zeros((b, hidden), dtype=xs.dtype, device=xs.device) if h0 is None else h0
    c = torch.zeros((b, hidden), dtype=torch.float32, device=xs.device) if c0 is None else c0
    ys = []
    for x_t in xs:
        h, c = lstm_cell(params, x_t, h, c, pwl=pwl)
        ys.append(h)
    return torch.stack(ys), (h, c)


def init_lstm_ae(generator: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """The paper's LSTM-AE: stacked seq-to-seq LSTM layers (encoder halves
    features to the bottleneck, decoder doubles back; final layer width =
    input width, reconstructing x_t per timestep)."""
    ae = cfg.lstm_ae
    layers = tuple(
        init_lstm_cell(generator, i, h, device)
        for i, h in zip(ae.layer_input_sizes(), ae.layer_sizes())
    )
    return {"layers": layers}


def lstm_ae_specs(cfg: ModelConfig) -> Params:
    return {"layers": tuple(lstm_cell_specs() for _ in cfg.lstm_ae.layer_sizes())}


def lstm_ae_sequential(params: Params, xs: torch.Tensor, pwl: bool = False) -> torch.Tensor:
    """Layer-by-layer execution (the traditional schedule the paper compares
    against): layer i runs over ALL timesteps before layer i+1 starts.
    xs: (T, B, F) -> reconstruction (T, B, F)."""
    ys = xs
    for layer in params["layers"]:
        ys, _ = lstm_layer(layer, ys, pwl=pwl)
    return ys


def lstm_ae_reconstruction_error(params: Params, xs: torch.Tensor,
                                 pwl: bool = False) -> torch.Tensor:
    """Per-sequence mean squared reconstruction error: (B,)."""
    recon = lstm_ae_sequential(params, xs, pwl=pwl)
    return torch.mean(torch.square(recon.float() - xs.float()), dim=(0, 2))


def stacked_cell_params(
    layer_params: Sequence[Params],
    in_max: Optional[int] = None,
    h_max: Optional[int] = None,
) -> tuple[Params, tuple, tuple]:
    """Zero-pad per-layer cells to common (In_max, H_max) and stack.

    Returns (stacked params {wx (N,In,4H), wh (N,H,4H), b (N,4H)},
    in_sizes (N,), hidden_sizes (N,)).  Zero padding is exact AND
    gate-aligned: each of the four gate column blocks is padded to h_max
    separately, so gate boundaries stay at multiples of h_max.  Padded
    input rows/hidden columns contribute nothing to valid gates, and
    downstream layers' padded wx rows null out any padded h values.
    """
    in_sizes = tuple(p["wx"].shape[0] for p in layer_params)
    hid_sizes = tuple(p["wh"].shape[0] for p in layer_params)
    in_max = in_max or max(in_sizes)
    h_max = h_max or max(hid_sizes)

    def pad_gates(w: torch.Tensor, rows_to: int) -> torch.Tensor:
        # the columns are 4 gate blocks: pad each block to h_max
        hh = w.shape[1] // 4
        return torch.cat(
            [F.pad(blk, (0, h_max - hh, 0, rows_to - w.shape[0])) for blk in w.chunk(4, dim=1)],
            dim=1,
        )

    def pad_bias(b: torch.Tensor) -> torch.Tensor:
        hh = b.shape[0] // 4
        return torch.cat([F.pad(blk, (0, h_max - hh)) for blk in b.chunk(4)])

    stacked = {
        "wx": torch.stack([pad_gates(p["wx"], in_max) for p in layer_params]),
        "wh": torch.stack([pad_gates(p["wh"], h_max) for p in layer_params]),
        "b": torch.stack([pad_bias(p["b"]) for p in layer_params]),
    }
    return stacked, in_sizes, hid_sizes
