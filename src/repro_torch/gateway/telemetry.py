"""Gateway telemetry: counters, gauges, and mergeable latency histograms.

A copy of ``repro/gateway/telemetry.py``, which imports no JAX: the port imports nothing
of ``repro``, and ``tests/test_torch_obs.py`` holds the copy to the original.

The software analogue of the paper's utilization discussion (Table 1):
whether the datapath stays fed is visible as *batch-fill ratio* (how much
of each flushed micro-batch was real work vs padding) and *pool
occupancy* (active slots / capacity).  Everything is plain host-side
bookkeeping — one `Telemetry` instance is shared by the session pool and
the micro-batching queue and surfaced via ``gateway.stats()``.

Latency lives in fixed-boundary log-linear histograms
(:class:`repro_torch.obs.histogram.Histogram`) instead of a raw sample ring:
per-worker histograms serialize through ``stats()`` as sparse bucket
dicts and SUM exactly across workers, so a multi-worker front reports
true front-wide percentiles.  Besides the request-latency histogram
(``request_ms``) there are per-stage histograms (``queue_wait_ms``,
``batch_wait_ms``, ``assemble_ms``, ``compute_ms``, ``wire_ms``,
``pool_step_ms``) decomposing where wire latency goes; stage recording
is gated by ``detail`` so the overhead benchmark can price it.

Scalar gauges and vector gauges (per-mesh-shard values) live in separate
maps — ``gauges`` is honestly ``dict[str, float]`` and ``gauge_vecs``
holds the tuples — and the uptime epoch is explicit: set at
construction and on every ``reset()``, so ``stats()`` rates are
well-defined from the first post-reset event instead of being inflated
until the window fills.

Single-threaded by design (the gateway is caller-driven); ``clock`` is
injectable so tests control time.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Iterable, Tuple

from repro_torch.obs.histogram import Histogram

# the request-latency histogram's key in ``Telemetry.histograms``
REQUEST_HIST = "request_ms"

# counters whose short-horizon rates feed the control plane (sliding
# window, not lifetime averages — see _RateWindow)
_WINDOWED_COUNTERS = ("queue.submitted", "queue.completed")


class _RateWindow:
    """Sliding-window event rate from a ring of per-interval counters.

    Lifetime rates (``count / uptime``) answer "how busy has this process
    been since boot" — useless to a controller that must react to the
    arrival rate *now*.  This ring holds one counter per fixed interval;
    ``add`` credits the interval containing ``now`` (zeroing any
    intervals skipped since the last event) and ``rate`` divides the
    ring's sum by the window span, clipped to the time actually elapsed
    since construction so the estimate is unbiased while the ring is
    still filling.
    """

    __slots__ = ("interval_s", "intervals", "_counts", "_last_idx", "_t_start")

    def __init__(self, t_start: float, window_s: float = 10.0, intervals: int = 20):
        if window_s <= 0 or intervals < 1:
            raise ValueError("window_s must be > 0 and intervals >= 1")
        self.interval_s = window_s / intervals
        self.intervals = intervals
        self._counts = [0.0] * intervals
        self._last_idx = int(t_start / self.interval_s)
        self._t_start = t_start

    @property
    def window_s(self) -> float:
        return self.interval_s * self.intervals

    def _advance(self, now: float) -> int:
        idx = int(now / self.interval_s)
        if idx > self._last_idx:
            # zero every interval skipped since the last event; a gap
            # longer than the ring clears it entirely
            for i in range(self._last_idx + 1,
                           min(idx, self._last_idx + self.intervals) + 1):
                self._counts[i % self.intervals] = 0.0
            self._last_idx = idx
        return idx

    def add(self, now: float, n: float = 1.0) -> None:
        idx = self._advance(now)
        self._counts[idx % self.intervals] += n

    def rate(self, now: float) -> float:
        """Events per second over the trailing window (clipped to the
        elapsed time while the ring is younger than one full window)."""
        self._advance(now)
        span = min(self.window_s, max(now - self._t_start, self.interval_s))
        return sum(self._counts) / span


def percentile(sorted_vals: list, p: float) -> float:
    """Nearest-rank percentile of an ascending list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


class Telemetry:
    """Counters + gauges + fixed-boundary latency histograms.

    counters    monotonically increasing event counts (requests, batches,
                stream-steps, rejections; per-protocol transport traffic
                as ``wire.req_json`` / ``wire.req_bp1`` and per-connection
                ``wire.conn_json`` / ``wire.conn_bp1`` — how much of a
                front's load negotiated the binary protocol)
    gauges      last-set scalar values (queue depth, pool occupancy)
    gauge_vecs  last-set per-shard vectors (device occupancy / flush fill)
    histograms  request latency + per-stage decompositions -> p50/p95/p99
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        detail: bool = True,
        rate_window_s: float = 10.0,
    ):
        self._clock = clock
        self.detail = bool(detail)
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.gauge_vecs: dict[str, Tuple[float, ...]] = {}
        self.histograms: dict[str, Histogram] = {}
        # explicit uptime epoch: rates are well-defined immediately, and
        # reset() re-arms it (no lazy first-event initialization)
        self._t0: float = clock()
        self._rate_window_s = float(rate_window_s)
        self._windows: dict[str, _RateWindow] = {
            name: _RateWindow(self._t0, self._rate_window_s)
            for name in _WINDOWED_COUNTERS
        }

    # -- recording --------------------------------------------------------

    def now(self) -> float:
        """The telemetry clock (injectable) — shared by instrumented call
        sites so stage timings and uptime agree on one time source."""
        return self._clock()

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] += n
        win = self._windows.get(name)
        if win is not None:
            win.add(self._clock(), n)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def gauge_vec(self, name: str, values: Iterable[float]) -> None:
        """A per-device gauge vector (e.g. slot occupancy or flush fill
        per mesh shard) — kept out of ``gauges`` so that map stays
        ``dict[str, float]``; ``stats()`` serialises vectors as JSON
        lists under ``gauge_vecs``."""
        self.gauge_vecs[name] = tuple(float(v) for v in values)

    def observe(self, name: str, ms: float) -> None:
        """Record one duration into the named histogram."""
        hist = self.histograms.get(name)
        if hist is None:
            hist = self.histograms[name] = Histogram()
        hist.record(float(ms))

    def observe_stage(self, name: str, ms: float) -> None:
        """Per-stage histogram sample; dropped when ``detail`` is off (the
        obs_overhead benchmark's 'off' arm)."""
        if self.detail:
            self.observe(name, ms)

    def observe_latency_ms(self, ms: float) -> None:
        self.observe(REQUEST_HIST, ms)

    def reset(self) -> None:
        """Zero all counters/gauges/histograms and re-arm the uptime
        epoch.  For drawing the line after warm-up traffic — compile
        warming must not inflate served-request counters or fill
        ratios — and rates are well-defined from the very next event."""
        self.counters.clear()
        self.gauges.clear()
        self.gauge_vecs.clear()
        self.histograms.clear()
        self._t0 = self._clock()
        self._windows = {
            name: _RateWindow(self._t0, self._rate_window_s)
            for name in _WINDOWED_COUNTERS
        }

    def record_batch(self, filled: int, slots: int, wait_ms: float = 0.0) -> None:
        """One micro-batch flush: ``filled`` real requests in ``slots``
        padded lanes (fill ratio = filled/slots aggregated over flushes)."""
        self.count("batch.flushes")
        self.count("batch.filled", filled)
        self.count("batch.slots", slots)
        self.count("batch.wait_ms", wait_ms)
        self.observe_stage("batch_wait_ms", wait_ms)

    def record_pool_step(self, active: int, capacity: int) -> None:
        """One pooled streaming step advancing ``active`` of ``capacity``
        slots.  Gauges the stepped fraction as ``pool.step_fill`` (the
        per-step analogue of datapath utilization); ``pool.occupancy``
        (resident slots / capacity) is gauged by the pool on admit/evict."""
        self.count("pool.steps")
        self.count("pool.stream_steps", active)
        self.gauge("pool.step_fill", active / max(1, capacity))

    # -- reading ----------------------------------------------------------

    @property
    def request_histogram(self) -> Histogram:
        hist = self.histograms.get(REQUEST_HIST)
        if hist is None:
            hist = self.histograms[REQUEST_HIST] = Histogram()
        return hist

    def latency_percentile(self, p: float) -> float:
        return self.request_histogram.percentile(p)

    @property
    def uptime_s(self) -> float:
        return max(self._clock() - self._t0, 1e-9)

    def windowed_rate(self, name: str) -> float:
        """Sliding-window rate (events/s) for a windowed counter; 0.0 for
        counters outside ``_WINDOWED_COUNTERS``."""
        win = self._windows.get(name)
        return win.rate(self._clock()) if win is not None else 0.0

    def stats(self) -> dict:
        c = self.counters
        flushes = c.get("batch.flushes", 0.0)
        slots = c.get("batch.slots", 0.0)
        steps = c.get("pool.stream_steps", 0.0)
        req = self.request_histogram
        up = self.uptime_s
        return {
            "uptime_s": up,
            "counters": dict(c),
            "gauges": dict(self.gauges),
            "gauge_vecs": {k: list(v) for k, v in self.gauge_vecs.items()},
            "batch_fill_ratio": (c.get("batch.filled", 0.0) / slots) if slots else 0.0,
            "mean_batch_wait_ms": (c.get("batch.wait_ms", 0.0) / flushes) if flushes else 0.0,
            "latency_ms": {
                "count": req.count,
                "p50": req.percentile(50),
                "p95": req.percentile(95),
                "p99": req.percentile(99),
                "sum_ms": req.sum,
                "buckets": {str(i): n for i, n in sorted(req.counts.items())},
            },
            "histograms": {k: h.to_dict() for k, h in self.histograms.items()},
            "requests_per_s": c.get("queue.completed", 0.0) / up,
            "stream_steps_per_s": steps / up,
            # windowed (short-horizon) rates — what the control plane
            # actuates on; the two keys above are lifetime averages
            "arrival_rps_window": self.windowed_rate("queue.submitted"),
            "completed_rps_window": self.windowed_rate("queue.completed"),
        }
