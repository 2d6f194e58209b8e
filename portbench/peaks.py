"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 data sheet, SXM part, at the full power limit of 700 W: 67
TFLOP/s in float32 outside the tensor cores, and 3.35 TB/s of HBM3.  A card set
below 700 W runs slower under load; the run prints its power limit beside its
numbers.

The same data sheet: 989.4 TFLOP/s in bf16 on the tensor cores, dense (the
sheet's 1,979 is with 2:4 sparsity), the peak of a bf16 model's ``mfu``.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "bf16_flops": 989.4e12,
        "hbm_bytes": 3.35e12,
    },
}


def peaks_of(kind: str) -> dict:
    """The peaks of card ``kind``; raises for a card the table does not hold,
    so a share of a peak is never read against the wrong card."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}; known: {sorted(PEAKS)}")
    return PEAKS[kind]


def bound_s(flops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: the larger of float32 operations
    over their peak and bytes over the memory's peak."""
    peak = peaks_of(kind)
    return max(flops / peak["fp32_flops"], nbytes / peak["hbm_bytes"])
