"""Temporal parallelism (paper Section 3): wavefront execution of a
multi-layer recurrent stack on one device.

At wavefront step k every layer fires at once, layer i processing timestep
``k - i``: one batched cell over the padded layer stack (a batched matmul
over the layer dimension takes the place of the reference's ``vmap``).
Counterpart of ``repro/core/temporal.py``; the multi-device
``build_stage_params`` / ``pipelined_forward`` wait for the multi-GPU slice.

Latency semantics match Eq (1): K = T + N - 1 wavefront steps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lstm import lstm_cell, stacked_cell_params
from repro_torch.utils import Params


def schedule_table(num_layers: int, timesteps: int) -> list[list[tuple[int, int]]]:
    """Which (layer, timestep) pairs execute at each wavefront step —
    documentation/test helper mirroring Fig. 2's staggered execution."""
    steps = []
    for k in range(timesteps + num_layers - 1):
        active = [(i, k - i) for i in range(num_layers) if 0 <= k - i < timesteps]
        steps.append(active)
    return steps


def wavefront_forward(params: Params, xs: torch.Tensor, pwl: bool = False) -> torch.Tensor:
    """Single-device wavefront execution.  xs: (T, B, F) -> (T, B, F).

    All N layers execute in ONE batched cell per wavefront step — the
    software rendering of "all modules operate concurrently" (paper §3.2).
    """
    layers = params["layers"]
    n = len(layers)
    t_len, b, f = xs.shape
    stacked, _, _ = stacked_cell_params(layers)
    in_max = stacked["wx"].shape[1]
    h_max = stacked["wh"].shape[1]
    cell_params = {"wx": stacked["wx"], "wh": stacked["wh"], "b": stacked["b"][:, None, :]}

    h = torch.zeros((n, b, h_max), dtype=xs.dtype, device=xs.device)
    c = torch.zeros((n, b, h_max), dtype=torch.float32, device=xs.device)
    x_pad = F.pad(xs, (0, in_max - f))
    x_zero = torch.zeros_like(x_pad[0])   # drain steps read zeros
    layer_ids = torch.arange(n, device=xs.device)
    ys = []
    for k in range(t_len + n - 1):
        x_k = x_pad[k] if k < t_len else x_zero
        # layer 0 reads the fresh input; layer i reads layer i-1's carry h
        upstream = F.pad(h[:-1], (0, in_max - h_max))
        in_buf = torch.cat([x_k[None], upstream], dim=0)       # (N, B, in_max)
        h_new, c_new = lstm_cell(cell_params, in_buf, h, c, pwl=pwl)
        t_for_layer = k - layer_ids
        vmask = ((t_for_layer >= 0) & (t_for_layer < t_len))[:, None, None]
        h = torch.where(vmask, h_new, h)
        c = torch.where(vmask, c_new, c)
        if k >= n - 1:
            ys.append(h[-1, :, :f])
    return torch.stack(ys)
