"""Reconstruction-error anomaly detection (the paper's application domain).

LSTM-AEs trained on benign data overfit normal behaviour; anomalous
sequences reconstruct poorly.  Threshold calibration on a benign validation
split + standard detection metrics, computed on the host in float64.
Counterpart of ``repro/core/anomaly.py``; inputs may be tensors on any
device or numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DetectionReport:
    threshold: float
    precision: float
    recall: float
    f1: float
    auroc: float
    anomaly_rate: float


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def calibrate_threshold(benign_errors, k_sigma: float = 3.0) -> float:
    """mean + k*std over benign reconstruction errors."""
    e = _host(benign_errors).astype(np.float64)
    return float(e.mean() + k_sigma * e.std())


def auroc(scores, labels) -> float:
    """Rank-based AUROC (Mann-Whitney U)."""
    scores, labels = _host(scores), _host(labels)
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))


def evaluate_detection(errors, labels, threshold: float) -> DetectionReport:
    """errors: (B,) reconstruction errors; labels: (B,) 1=anomalous."""
    e = _host(errors).astype(np.float64)
    y = _host(labels).astype(int)
    pred = (e > threshold).astype(int)
    tp = int(((pred == 1) & (y == 1)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    precision = tp / max(1, tp + fp)
    recall = tp / max(1, tp + fn)
    f1 = 2 * precision * recall / max(1e-12, precision + recall)
    return DetectionReport(
        threshold=threshold,
        precision=precision,
        recall=recall,
        f1=f1,
        auroc=auroc(e, y),
        anomaly_rate=float(pred.mean()),
    )
