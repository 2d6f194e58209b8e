"""Priority-aware admission control with per-tenant token buckets.

Copy of ``repro/control/admission.py`` (pure Python, no JAX).

Flat backpressure (``GatewayOverloadedError`` at ``max_queue`` pending)
sheds whoever arrives last, which under overload is exactly backwards:
the paper's deployment story is a detector guarding real equipment, so
an alert-path request must survive a flood of best-effort backfill.
:class:`AdmissionController` layers declared priority classes on top of
the same queue-depth signal — class 0 (highest) keeps the flat limit
verbatim, class ``k`` of ``n`` is admitted only while the queue is under
``(1 - k/n)`` of ``max_queue`` — so shedding starts at the bottom class
and climbs, and a deployment with one class (or clients that never send
``priority``) behaves bit-for-bit like the flat gateway.

Each shed increments a per-class counter (``admission.shed_p<k>``,
rendered on ``/metrics`` like any counter) so shed *fairness* is
observable, and an optional per-tenant token bucket rate-limits chatty
tenants before they reach the queue at all (``admission.rate_limited``).

Single-threaded like the gateway that owns it; ``clock`` is injectable.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.gateway.queue import GatewayOverloadedError
from repro_torch.gateway.telemetry import Telemetry


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``."""

    __slots__ = ("rate", "burst", "_tokens", "_t_last")

    def __init__(self, rate: float, burst: float, now: float):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t_last = now

    def try_take(self, now: float, n: float = 1.0) -> bool:
        elapsed = max(0.0, now - self._t_last)
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._t_last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens


class AdmissionController:
    """Depth-thresholded priority classes + optional tenant rate limit."""

    def __init__(
        self,
        *,
        classes: int = 1,
        tenant_rate: Optional[float] = None,
        tenant_burst: Optional[float] = None,
        telemetry: Optional[Telemetry] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if classes < 1:
            raise ValueError(f"need at least one priority class, got {classes}")
        self.classes = int(classes)
        self.tenant_rate = float(tenant_rate) if tenant_rate else None
        self.tenant_burst = (
            float(tenant_burst) if tenant_burst
            else (2.0 * self.tenant_rate if self.tenant_rate else None)
        )
        self.telemetry = telemetry or Telemetry(clock=clock)
        self._clock = clock
        self._buckets: dict[str, TokenBucket] = {}

    # -- policy ------------------------------------------------------------

    def normalize(self, priority) -> int:
        """Clamp a wire ``priority`` into [0, classes); None (legacy
        clients) maps to class 0 — exactly the old flat behaviour."""
        if priority is None:
            return 0
        return min(max(0, int(priority)), self.classes - 1)

    def depth_limit(self, klass: int, max_queue: int) -> int:
        """Queue depth below which class ``klass`` is still admitted.

        Class 0's limit is ``max_queue`` itself (flat semantics kept
        verbatim); each lower class gives up an equal share of headroom,
        so under rising depth class ``n-1`` sheds first and class 0 last.
        """
        if klass == 0:
            return int(max_queue)
        return max(1, int(max_queue * (1.0 - klass / self.classes)))

    def admit(
        self,
        *,
        depth: int,
        max_queue: int,
        priority=None,
        tenant: Optional[str] = None,
    ) -> int:
        """Gate one request before it reaches the queue.

        Returns the normalized priority class on admission; raises
        :class:`GatewayOverloadedError` on shed (per-class counter) or
        tenant rate limit.  The queue's own ``max_queue`` check still
        runs afterwards — this controller only ever sheds *earlier*.
        """
        klass = self.normalize(priority)
        if self.tenant_rate is not None:
            key = str(tenant) if tenant is not None else "_default"
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = TokenBucket(
                    self.tenant_rate, self.tenant_burst, self._clock()
                )
            if not bucket.try_take(self._clock()):
                self.telemetry.count("admission.rate_limited")
                raise GatewayOverloadedError(
                    f"tenant {key!r} over rate limit "
                    f"({self.tenant_rate:g} req/s, burst {self.tenant_burst:g})"
                )
        if depth >= self.depth_limit(klass, max_queue):
            self.telemetry.count(f"admission.shed_p{klass}")
            raise GatewayOverloadedError(
                f"queue depth {depth} at or past class-{klass} admission "
                f"limit {self.depth_limit(klass, max_queue)} "
                f"(max_queue={max_queue}); shed"
            )
        self.telemetry.count(f"admission.admitted_p{klass}")
        return klass

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        c = self.telemetry.counters
        return {
            "classes": self.classes,
            "tenant_rate": self.tenant_rate,
            "tenant_burst": self.tenant_burst,
            "tenants_tracked": len(self._buckets),
            "shed_by_class": {
                str(k): c.get(f"admission.shed_p{k}", 0.0)
                for k in range(self.classes)
            },
            "rate_limited": c.get("admission.rate_limited", 0.0),
        }
