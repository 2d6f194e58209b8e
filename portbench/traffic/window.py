"""Single-window traffic: one window per request, one caller in a closed loop
(``closed_loop.py``).

The inputs are a pool of ``pool`` distinct (1, ``seq_len``, features) float32
windows, drawn on the device from the seed in one batch and held in pageable
host memory (as a sensor's window arrives); request i scores window i mod
``pool``.  The reference scores the pool ``block`` windows at a time.

``SMALL`` holds the parameters at which a test runs a cell, a size a test run
holds, and
``CONTROL_SECONDS`` the control's window (``control.py``): long enough for the
control to answer all 4,096 windows of the pool, 6 ms a window at f64-d6 on an
H100.
"""
from __future__ import annotations

import torch

from portbench.closed_loop import Pool, drive, request, warm  # noqa: F401
from portbench.series import make_windows

SMALL = {"pool": 6, "reference_block": 6, "warmup_requests": 1}
CONTROL_SECONDS = 40.0


def build(cfg: dict, params: dict, gen: torch.Generator, device: torch.device) -> Pool:
    n, t = int(params["pool"]), int(params["seq_len"])
    f = int(cfg["input_features"])
    x, _ = make_windows(gen, n, t, f, float(params["anomaly_rate"]))
    pool = x.cpu().view(n, 1, t, f)
    return Pool(pool=pool, seq_len=t, block=int(params["reference_block"]),
                warmup=int(params["warmup_requests"]),
                trace_requests=int(params["trace_requests"]))
