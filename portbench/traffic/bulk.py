"""Bulk traffic: requests of ``batch`` windows each, one caller in a closed loop
(``closed_loop.py``).

The inputs are a pool of ``pool`` distinct batches of (``batch``, ``seq_len``,
features) float32 windows, drawn on the device from the seed and held in pinned
host memory where ``pinned`` (as a loader with ``pin_memory=True`` hands them
over), pageable otherwise; request i scores batch i mod ``pool``.

``SMALL`` holds the parameters at which a test runs a cell, a size a test run
holds, and
``CONTROL_SECONDS`` the control's window (``control.py``): long enough to
answer every batch of the pool.
"""
from __future__ import annotations

import torch

from portbench.closed_loop import Pool, drive, request, warm  # noqa: F401
from portbench.series import make_windows

SMALL = {"batch": 8, "pool": 2, "warmup_requests": 1}
CONTROL_SECONDS = 2.0


def build(cfg: dict, params: dict, gen: torch.Generator, device: torch.device) -> Pool:
    n, b, t = int(params["pool"]), int(params["batch"]), int(params["seq_len"])
    f = int(cfg["input_features"])
    pinned = bool(params["pinned"]) and device.type == "cuda"
    pool = torch.empty((n, b, t, f), dtype=torch.float32, pin_memory=pinned)
    for k in range(n):
        x, _ = make_windows(gen, b, t, f, float(params["anomaly_rate"]))
        pool[k].copy_(x)
    return Pool(pool=pool, seq_len=t, block=b, warmup=int(params["warmup_requests"]),
                trace_requests=int(params["trace_requests"]))
