"""Seeded windows of a multivariate series, drawn on the device.

The semantics of ``repro_torch/data/timeseries.py::make_batch``, rewritten as a
few large torch calls on the device: benign windows are per-feature sine
mixtures, amp * sin(2 pi freq t + phase) with freq in U(0.05, 0.45), phase in
U(0, 2 pi) and amp in U(0.5, 1), plus N(0, 0.05^2) noise.  A share
``anomaly_rate`` of the windows gets one of three faults on a quarter of its
features: a spike of U(2, 4) over [w0, w1), a level shift of U(1, 2) from w0 on,
or white N(0, 1) noise over [w0, w1), with w0 in [0, T - T//4) and
w1 = min(T, w0 + L), L in [max(2, T//8), max(3, T//3)).  The draws are torch's,
so the values differ from the numpy original's; the distribution is the same.
"""
from __future__ import annotations

import math

import torch


def make_windows(gen: torch.Generator, count: int, seq_len: int, features: int,
                 anomaly_rate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(windows (count, T, F) float32, labels (count,) bool) on ``gen``'s device."""
    dev = gen.device
    t_len, f = seq_len, features

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    freq = uniform(0.05, 0.45, count, 1, f)
    phase = uniform(0.0, 2 * math.pi, count, 1, f)
    amp = uniform(0.5, 1.0, count, 1, f)
    steps = torch.arange(t_len, device=dev, dtype=torch.float32)[None, :, None]
    x = amp * torch.sin(2 * math.pi * freq * steps + phase)
    x += 0.05 * torch.randn((count, t_len, f), generator=gen, device=dev)

    labels = torch.rand(count, generator=gen, device=dev) < anomaly_rate
    kind = torch.randint(0, 3, (count,), generator=gen, device=dev)
    w0 = torch.randint(0, max(1, t_len - t_len // 4), (count,), generator=gen, device=dev)
    lo, hi = max(2, t_len // 8), max(3, t_len // 3)
    w1 = torch.clamp(w0 + torch.randint(lo, hi, (count,), generator=gen, device=dev), max=t_len)
    # a quarter of the features, without repeats: the k smallest of a random rank
    rank = torch.rand((count, f), generator=gen, device=dev).argsort(dim=1).argsort(dim=1)
    feats = rank < max(1, f // 4)
    t = torch.arange(t_len, device=dev)[None, :]
    spans = torch.where((kind == 1)[:, None], t >= w0[:, None],
                        (t >= w0[:, None]) & (t < w1[:, None]))
    mask = labels[:, None, None] & spans[:, :, None] & feats[:, None, :]
    shift = torch.where(kind == 0, uniform(2.0, 4.0, count), uniform(1.0, 2.0, count))
    noise = torch.randn((count, t_len, f), generator=gen, device=dev)
    is_noise = (kind == 2)[:, None, None]
    x = torch.where(mask & is_noise, noise, x + (mask & ~is_noise) * shift[:, None, None])
    return x.contiguous(), labels
