"""Synthetic multivariate time-series for LSTM-AE anomaly detection.

Benign data: mixtures of per-feature sinusoids (random frequency/phase) +
noise — the "normal behaviour" an LSTM-AE overfits.  Anomalies inject one
of three patterns (spike, level shift, frequency break) into a contiguous
window.  Deterministic per (seed, index).

Counterpart of ``repro/data/timeseries.py``: the same numpy draws, so the
batches are bit-equal to the reference's; they come back as CPU tensors and
the engine moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class TimeseriesConfig:
    features: int = 32
    seq_len: int = 64
    batch: int = 64
    anomaly_rate: float = 0.0   # fraction of anomalous sequences
    seed: int = 0


def _benign_batch(rng: np.random.Generator, b: int, t: int, f: int) -> np.ndarray:
    freq = rng.uniform(0.05, 0.45, size=(b, 1, f))
    phase = rng.uniform(0, 2 * np.pi, size=(b, 1, f))
    amp = rng.uniform(0.5, 1.0, size=(b, 1, f))
    steps = np.arange(t)[None, :, None]
    base = amp * np.sin(2 * np.pi * freq * steps + phase)
    noise = 0.05 * rng.standard_normal((b, t, f))
    return (base + noise).astype(np.float32)


def _inject_anomalies(rng: np.random.Generator, x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    b, t, f = x.shape
    out = x.copy()
    for i in np.nonzero(mask)[0]:
        kind = rng.integers(0, 3)
        w0 = rng.integers(0, max(1, t - t // 4))
        w1 = min(t, w0 + rng.integers(max(2, t // 8), max(3, t // 3)))
        feats = rng.choice(f, size=max(1, f // 4), replace=False)
        if kind == 0:    # spike
            out[i, w0:w1, feats] += rng.uniform(2.0, 4.0)
        elif kind == 1:  # level shift
            out[i, w0:, feats] += rng.uniform(1.0, 2.0)
        else:            # frequency break -> white noise segment
            # fancy-index dim comes first: result is (len(feats), w1-w0)
            out[i, w0:w1, feats] = rng.standard_normal(
                (len(feats), int(w1 - w0))
            ).astype(np.float32)
    return out


def make_batch(cfg: TimeseriesConfig, index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic batch #index -> (series (B,T,F), labels (B,) 1=anomaly), on the CPU."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, index]))
    x = _benign_batch(rng, cfg.batch, cfg.seq_len, cfg.features)
    labels = (rng.uniform(size=cfg.batch) < cfg.anomaly_rate).astype(np.int32)
    if labels.any():
        x = _inject_anomalies(rng, x, labels)
    return torch.from_numpy(x), torch.from_numpy(labels)


@dataclass
class TimeseriesIterator:
    """Checkpointable iterator: state == (cfg, next_index)."""
    cfg: TimeseriesConfig
    index: int = 0

    def __next__(self) -> tuple[torch.Tensor, torch.Tensor]:
        batch = make_batch(self.cfg, self.index)
        self.index += 1
        return batch

    def __iter__(self) -> "TimeseriesIterator":
        return self

    def state_dict(self) -> dict:
        return {"index": self.index, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on restore: state has seed {state['seed']}, "
                             f"this iterator {self.cfg.seed}")
        self.index = int(state["index"])
