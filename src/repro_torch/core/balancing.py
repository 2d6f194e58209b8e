"""Copy of ``repro/core/balancing.py``, word for word apart from its imports
(the port imports nothing of ``repro``).  The numbers here are the
paper's FPGA cycle model, not device measurements.

Dataflow balancing (paper Section 3.2-3.3): the reuse-factor latency
model, Eqs (1)-(8), plus the TPU-side projection (layer -> stage makespan
partition, since a TPU core cannot be fractionally provisioned the way FPGA
multipliers can — see DESIGN.md §2).

All equations reference the paper:

  (1) Acc_Lat = T*Lat_t_m + sum_{i != m} Lat_t_i
  (2) Lat_t_i = max(X_t_i, H_t_i)
  (3) X_t_i = LX_i*RX_i + LH_i        (4) H_t_i = LH_i*RH_i + LH_i
  (5) RX_i = 4*LH_i / MX_i            (6) RH_i = 4*LH_i / MH_i
  (7) RX_i = (LH_i/LX_i) * RH_i
  (8) RH_i = (LH_m - LH_i)/LH_i + (LH_m/LH_i)*RH_m
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.config.core import LSTMAEConfig


@dataclass(frozen=True)
class LayerBalance:
    """Balanced configuration of one LSTM_i module."""
    index: int
    lx: int           # input feature dim LX_i
    lh: int           # hidden dim LH_i
    rx: int           # reuse factor of MVM_X (>= 1, integer like hardware)
    rh: int           # reuse factor of MVM_H
    x_t: int          # Eq (3)
    h_t: int          # Eq (4)
    lat_t: int        # Eq (2)
    mx: float         # parallel multipliers in MVM_X, Eq (5)
    mh: float         # parallel multipliers in MVM_H, Eq (6)


def mvm_x_latency(lx: int, lh: int, rx: int) -> int:
    return lx * rx + lh  # Eq (3)


def mvm_h_latency(lh: int, rh: int) -> int:
    return lh * rh + lh  # Eq (4)


def balanced_rx(lx: int, lh: int, rh: float) -> float:
    return (lh / lx) * rh  # Eq (7)


def balanced_rh(lh_i: int, lh_m: int, rh_m: float) -> float:
    return (lh_m - lh_i) / lh_i + (lh_m / lh_i) * rh_m  # Eq (8)


def multipliers(lh: int, r: float) -> float:
    return 4.0 * lh / r  # Eq (5)/(6) inverted


def balance_model(cfg: LSTMAEConfig, rh_m: int) -> list[LayerBalance]:
    """Apply the paper's balancing methodology to an LSTM-AE model.

    The bottleneck module m is the one with the largest LH (its H_t
    dominates once internally balanced).  Reuse factors are integers >= 1 in
    hardware; we ceil, which can only make a module *slower* than the ideal
    — the paper accepts the same rounding.
    """
    sizes = cfg.layer_sizes()
    in_sizes = cfg.layer_input_sizes()
    lh_m = max(sizes)
    out: list[LayerBalance] = []
    for i, (lx, lh) in enumerate(zip(in_sizes, sizes)):
        rh = max(1, math.ceil(balanced_rh(lh, lh_m, rh_m)))
        # Eq (7) can be fractional; hardware reuse factors are integers.
        # Round DOWN (spend a few more multipliers) so X_t <= H_t and the
        # intra-module balance max(X_t, H_t) = H_t survives the rounding.
        rx = max(1, math.floor(balanced_rx(lx, lh, rh)))
        x_t = mvm_x_latency(lx, lh, rx)
        h_t = mvm_h_latency(lh, rh)
        out.append(
            LayerBalance(
                index=i, lx=lx, lh=lh, rx=rx, rh=rh,
                x_t=x_t, h_t=h_t, lat_t=max(x_t, h_t),
                mx=multipliers(lh, rx), mh=multipliers(lh, rh),
            )
        )
    return out


def accelerator_latency_cycles(timesteps: int, balances: list[LayerBalance]) -> int:
    """Eq (1): steady-state bottleneck + pipeline fill/drain of the others."""
    lat_m = max(b.lat_t for b in balances)
    fill_drain = sum(b.lat_t for b in balances) - lat_m
    return timesteps * lat_m + fill_drain


def sequential_latency_cycles(timesteps: int, balances: list[LayerBalance]) -> int:
    """Layer-by-layer execution latency (no temporal parallelism): every
    layer runs over all T timesteps before the next starts."""
    return timesteps * sum(b.lat_t for b in balances)


def total_multipliers(balances: list[LayerBalance]) -> float:
    return sum(b.mx + b.mh for b in balances)


def utilization(balances: list[LayerBalance]) -> float:
    """Fraction of multiplier-cycles doing useful work in steady state.

    A module with Lat_t_i < Lat_t_m idles for the difference; perfect
    balancing -> 1.0.  This is the quantity the paper's Eq-8 maximises.
    """
    lat_m = max(b.lat_t for b in balances)
    used = sum((b.mx + b.mh) * b.lat_t for b in balances)
    avail = total_multipliers(balances) * lat_m
    return used / avail


# ---------------------------------------------------------------------------
# TPU projection: layer -> stage partition (DESIGN.md §2).
# A TPU pipeline has S equal cores, not per-layer multiplier budgets; the
# balancing problem becomes: partition contiguous layers into <= S groups
# minimising the bottleneck group cost (classic linear-partition DP, exact).
# ---------------------------------------------------------------------------

def stage_partition(costs: list[float], n_stages: int) -> tuple[list[int], float]:
    """Exact DP.  Returns (stage id per layer, bottleneck cost)."""
    n = len(costs)
    n_stages = max(1, min(n_stages, n))
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    inf = float("inf")
    # dp[s][i] = minimal bottleneck for first i layers in s stages
    dp = [[inf] * (n + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(n_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(1, n + 1):
            for j in range(s - 1, i):
                cand = max(dp[s - 1][j], prefix[i] - prefix[j])
                if cand < dp[s][i]:
                    dp[s][i] = cand
                    cut[s][i] = j
    best_s = min(range(1, n_stages + 1), key=lambda s: (dp[s][n], s))
    assignment = [0] * n
    i, s = n, best_s
    while s > 0:
        j = cut[s][i]
        for k in range(j, i):
            assignment[k] = s - 1
        i, s = j, s - 1
    return assignment, dp[best_s][n]


def lstm_layer_flops(lx: int, lh: int) -> float:
    """Per-timestep MACs of one LSTM layer (both MVMs, Fig. 1)."""
    return 4.0 * lh * (lx + lh)


def stage_assignment_for(cfg: LSTMAEConfig, n_stages: int) -> tuple[list[int], float]:
    """Balance the paper's model onto ``n_stages`` pipeline stages by
    per-timestep FLOPs (the TPU analogue of Eq 8)."""
    costs = [
        lstm_layer_flops(lx, lh)
        for lx, lh in zip(cfg.layer_input_sizes(), cfg.layer_sizes())
    ]
    return stage_partition(costs, n_stages)
