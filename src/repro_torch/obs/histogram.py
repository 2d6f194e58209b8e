"""Mergeable log-linear (HDR-style) latency histograms.

A copy of ``repro/obs/histogram.py``, which imports no JAX: the port imports nothing
of ``repro``, and ``tests/test_torch_obs.py`` holds the copy to the original.

Every histogram in the stack shares ONE fixed bucket layout: each
power-of-two octave of the value range is split into ``_SUBS`` linear
sub-buckets, giving a bounded relative error of ``1/_SUBS`` per bucket
across ~10 decades of dynamic range.  Because the boundaries are fixed
(not data-dependent), merging histograms is exact: summing bucket counts
from N workers yields bit-for-bit the histogram that would have been
built from the union of their samples.  That is what lets
``WorkerFront.stats()`` report true front-wide p50/p95/p99 over the
control pipes instead of the worst worker's percentiles.

Percentiles use the same nearest-rank convention as
:func:`repro_torch.gateway.telemetry.percentile` and return the lower bound of
the bucket holding the ranked sample; values recorded exactly on a
bucket bound round-trip unchanged (``bucket_bound(bucket_index(v)) ==
v``), which the merge-exactness tests exploit.

Counts are stored sparsely (``{bucket_index: count}``) so a histogram
serializes as a small JSON-safe dict that crosses both the workers'
pickled control pipes and the JSON wire protocol.
"""
from __future__ import annotations

import math
from typing import Iterable, Mapping, Optional

# 16 linear sub-buckets per power-of-two octave: <= 6.25% relative error.
_SUBS = 16
# Value range in ms: 2**-10 ms (~1 us) up to 2**24 ms (~4.7 h).  Values
# below the floor land in bucket 0 (bound 0.0); values at or above the
# ceiling land in the overflow bucket.
_E_MIN = -10
_E_MAX = 24
_MIN_VALUE = 2.0 ** _E_MIN

OVERFLOW_INDEX = 1 + (_E_MAX - _E_MIN) * _SUBS
NUM_BUCKETS = OVERFLOW_INDEX + 1


def bucket_index(value: float) -> int:
    """Bucket index for ``value`` (ms).  Total order: higher value ->
    higher (or equal) index; sub-1us, non-finite-small and negative
    values all collapse into bucket 0."""
    if not value >= _MIN_VALUE:  # also catches NaN
        return 0
    m, e = math.frexp(value)  # value = m * 2**e with m in [0.5, 1)
    e -= 1  # value = (2m) * 2**e with 2m in [1, 2)
    if e >= _E_MAX or value == math.inf:
        return OVERFLOW_INDEX
    # (2m - 1) is a binary fraction, so the sub-bucket index is exact for
    # values that sit precisely on a bucket bound (no float drift).
    sub = int((m * 2.0 - 1.0) * _SUBS)
    return 1 + (e - _E_MIN) * _SUBS + sub


def bucket_bound(index: int) -> float:
    """Inclusive lower bound (ms) of bucket ``index`` — the canonical
    representative value reported for samples in that bucket."""
    if index <= 0:
        return 0.0
    if index >= OVERFLOW_INDEX:
        return float(2.0 ** _E_MAX)
    e, sub = divmod(index - 1, _SUBS)
    return (2.0 ** (_E_MIN + e)) * (1.0 + sub / _SUBS)


class Histogram:
    """Sparse fixed-boundary histogram; merge by summing bucket counts."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.count: int = 0
        self.sum: float = 0.0

    # -- recording --------------------------------------------------------

    def record(self, value: float) -> None:
        idx = bucket_index(value)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.sum += float(value)

    def record_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.record(v)

    def clear(self) -> None:
        self.counts.clear()
        self.count = 0
        self.sum = 0.0

    # -- merging ----------------------------------------------------------

    def merge_from(self, other: "Histogram") -> "Histogram":
        """Add ``other``'s buckets into this histogram (exact: shared
        fixed boundaries mean no re-binning error).  Returns self."""
        for idx, n in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + n
        self.count += other.count
        self.sum += other.sum
        return self

    @classmethod
    def merged(cls, parts: Iterable["Histogram"]) -> "Histogram":
        out = cls()
        for part in parts:
            out.merge_from(part)
        return out

    # -- reading ----------------------------------------------------------

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile (same convention as
        ``telemetry.percentile``); 0.0 when empty.  Returns the lower
        bound of the bucket containing the ranked sample, so values
        recorded exactly on bucket bounds reproduce raw-sample
        percentiles bit for bit."""
        if self.count == 0:
            return 0.0
        rank = min(self.count - 1,
                   max(0, int(round(p / 100.0 * (self.count - 1)))))
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if rank < seen:
                return bucket_bound(idx)
        return bucket_bound(max(self.counts))  # unreachable; counts agree

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def cumulative(self) -> list:
        """Ascending ``[(upper_bound_ms_or_inf, cumulative_count), ...]``
        over occupied buckets — the Prometheus ``le`` view.  The final
        entry is always ``(inf, count)``."""
        out = []
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            upper = math.inf if idx >= OVERFLOW_INDEX else bucket_bound(idx + 1)
            out.append((upper, seen))
        if not out or out[-1][0] != math.inf:
            out.append((math.inf, self.count))
        return out

    # -- serialization (JSON/pickle-safe) ----------------------------------

    def to_dict(self) -> dict:
        """Plain-dict form (string bucket keys, JSON object compatible)."""
        return {
            "counts": {str(idx): n for idx, n in sorted(self.counts.items())},
            "count": self.count,
            "sum": self.sum,
        }

    @classmethod
    def from_dict(cls, data: Optional[Mapping]) -> "Histogram":
        """Inverse of :meth:`to_dict`; tolerates None/empty/partial dicts
        (wire payloads from a worker mid-boot may omit histograms)."""
        out = cls()
        if not data:
            return out
        counts = data.get("counts") or {}
        for key, n in counts.items():
            out.counts[int(key)] = out.counts.get(int(key), 0) + int(n)
        out.count = int(data.get("count", sum(out.counts.values())))
        out.sum = float(data.get("sum", 0.0))
        return out

    def __repr__(self) -> str:
        return (f"Histogram(count={self.count}, p50={self.percentile(50):.3g}, "
                f"p99={self.percentile(99):.3g})")
