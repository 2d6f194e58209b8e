"""Streaming anomaly gateway: micro-batched serving over the execution engine.

Counterpart of ``repro/gateway/__init__.py``.  One :class:`AnomalyGateway`
fronts an :class:`~repro_torch.engine.AnomalyService` (or a bare bound
:class:`~repro_torch.engine.Engine`) with the two serving surfaces the
paper's deployment needs:

* **streaming sessions** — ``admit / step / evict / reset`` on a
  fixed-capacity :class:`~repro_torch.gateway.pool.SessionPool`: up to
  ``capacity`` concurrent streams share ONE masked step over the pooled
  state block on the GPU, so thousands of logical streams churn through
  it (the software analogue of the paper's always-fed datapath).
* **one-shot scoring** — ``submit / pump / score`` on a
  :class:`~repro_torch.gateway.queue.MicroBatcher`: requests are
  shape-bucketed by sequence length, padded to bucket boundaries, flushed
  on ``max_batch``/``max_wait_ms``, and rejected with
  :class:`GatewayOverloadedError` once ``max_queue`` are pending.  Under
  the ``fused`` schedule each flush runs K1, the CUDA LSTM cell.

``gateway.stats()`` surfaces the shared :class:`Telemetry` (queue depth,
batch-fill ratio, p50/p95 latency, per-schedule throughput) in the
reference's schema.  The detector is refreshed in place via
:meth:`AnomalyGateway.recalibrate` — no drain required.

A live deployment fronts the gateway with the socket transport of
:mod:`repro_torch.gateway.server` (bp1 frames and JSON lines, a background
pump, one pool session per connection), whose event loop runs on one
thread: every pool step and flush of a gateway, and so every replay of its
captured programs, runs on that thread.  Durable sessions attach through
:func:`repro_torch.gateway.durability.enable_durability` (``durability``),
the control plane through :func:`repro_torch.control.enable_control`
(``control``: priority admission, SLO-driven batching knobs).  Several
gateways behind one port, one per worker process, are
:class:`repro_torch.gateway.workers.WorkerFront`.

Both surfaces follow the engine's placement: under
``open_gateway(placement=Placement.data(N))`` the gateway gets its own
engine on that placement, the pool's slot block splits over the N
devices (capacity scales to ``slots_per_device x N``), bucket flushes
score data-parallel padded to a per-device multiple, and ``stats()``
gains a ``placement`` section with per-device slot occupancy beside the
``pool.device_active`` and ``queue.device_fill`` gauges.  The single
placement is a strict no-op.
"""
from __future__ import annotations

import time
from typing import Callable, Hashable, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.engine.base import Engine
from repro_torch.engine.placement import Placement
from repro_torch.engine.schedules import schedule_cache_info
from repro_torch.gateway.pool import PoolFullError, SessionPool, UnknownStreamError
from repro_torch.gateway.queue import GatewayOverloadedError, MicroBatcher, Ticket, bucket_for
from repro_torch.gateway.telemetry import Telemetry
from repro_torch.obs import EventLog, Tracer

_UNSET = object()


class AnomalyGateway:
    """Session pool + micro-batching queue + telemetry over one engine."""

    def __init__(
        self,
        service_or_engine,
        *,
        capacity: int = 32,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        max_queue: int = 1024,
        max_seq_len: Optional[int] = None,
        placement: Optional[Placement] = None,
        clock: Callable[[], float] = time.monotonic,
        obs_detail: bool = True,
    ):
        engine = getattr(service_or_engine, "engine", service_or_engine)
        if not isinstance(engine, Engine):
            raise TypeError(
                f"expected AnomalyService or Engine, got {type(service_or_engine)!r}"
            )
        engine._require_params()  # fail fast: a gateway serves a bound model
        self.service = service_or_engine if service_or_engine is not engine else None
        if placement is not None:
            if not isinstance(placement, Placement):
                raise TypeError(
                    f"placement must be a Placement, got {type(placement)!r}"
                )
            # re-lay the engine out on the requested devices; a matching
            # placement returns the engine itself (strict no-op).  The
            # fronted service keeps its own engine and rebinds this one on
            # every param swap (see recalibrate)
            engine = engine.with_placement(placement)
        self.engine = engine
        if self.service is not None:
            # let the service rebind this gateway's engine on recalibrate —
            # a gateway with its own Engine must never serve stale params
            registry = getattr(self.service, "_gateways", None)
            if registry is not None:
                registry.add(self)
        self._threshold: Optional[float] = None  # used when fronting a bare Engine
        # session durability is opt-in: durability.enable_durability()
        # attaches a DurableSessions coordinator here and the transport and
        # stats pick it up; None keeps plain sessions (no snapshots, no
        # tokens).  The control plane is opt-in the same way:
        # control.enable_control() attaches a GatewayControl whose
        # admission gates submit() and whose ticks ride the transport's
        # pump; None keeps flat admission and static knobs
        self.durability = None
        self.control = None
        # observability plane: per-stage histograms gate on ``obs_detail``,
        # the tracer produces spans for requests that opt in, and the
        # event log is a no-op until attach_event_log() points it at a
        # JSONL file
        self.telemetry = Telemetry(clock=clock, detail=obs_detail)
        self.events = EventLog(None)
        self.tracer = Tracer(clock=clock, events=self.events)
        self.pool = SessionPool(engine, capacity, telemetry=self.telemetry)
        self.batcher = MicroBatcher(
            engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue=max_queue, max_seq_len=max_seq_len,
            telemetry=self.telemetry, clock=clock,
        )

    # -- streaming sessions (pool) ----------------------------------------

    def admit(self, stream_id: Hashable) -> int:
        return self.pool.admit(stream_id)

    def evict(self, stream_id: Hashable) -> float:
        return self.pool.evict(stream_id)

    def reset(self, stream_id: Hashable) -> None:
        self.pool.reset(stream_id)

    def step(self, inputs: Mapping[Hashable, "object"]) -> dict:
        return self.pool.step(inputs)

    # -- one-shot scoring (micro-batcher) ---------------------------------

    def submit(self, series, *, priority=None, tenant=None) -> Ticket:
        """Enqueue one (T, F) window: first come, first queued, shed at
        ``max_queue``.  ``priority`` and ``tenant`` are what a control
        plane's admission reads (shed the lowest class first, rate-limit
        a tenant); with none attached they are ignored."""
        if self.control is not None:
            self.control.admit(priority=priority, tenant=tenant)
        return self.batcher.submit(series)

    def pump(self, now: Optional[float] = None) -> int:
        return self.batcher.pump(now)

    def flush(self) -> int:
        return self.batcher.flush()

    def score(self, windows: Sequence) -> "object":
        return self.batcher.score(windows)

    # -- live recalibration ------------------------------------------------

    @property
    def threshold(self) -> Optional[float]:
        """The detector threshold alerts compare against (None before any
        calibration).  Lives on the fronted service when there is one."""
        if self.service is not None:
            return self.service.threshold
        return self._threshold

    def recalibrate(
        self, *, threshold=_UNSET, params: Optional["object"] = None
    ) -> dict:
        """Swap the detection threshold and/or model params in place.

        The swap is atomic from the serving paths' point of view: resident
        pool streams keep their slots, carried ``(h, c)`` state and running
        errors, and queued one-shot requests stay queued — each pool step /
        flush reads the engine's *current* params and each alert decision
        reads the *current* threshold, so new values simply apply from the
        next operation on.  No drain, no eviction (the ROADMAP's
        "threshold/calibration refresh without draining sessions").

        ``threshold`` may be a float or None (disable alerting); omit it to
        leave the threshold untouched.  ``params`` rebinds the engine (and
        the fronted service, keeping the two views consistent).  Returns
        ``{"threshold": ..., "params_swapped": ...}``.
        """
        if params is not None:
            # one swap path for every view: the service's _bind rebinds its
            # own engine AND every registered gateway engine, so no sibling
            # gateway serves stale params
            binder = getattr(self.service, "_bind", None)
            if binder is not None:
                binder(params)
            else:  # fronting a bare Engine (or a duck-typed service)
                self.engine.bind(params)
                if self.service is not None:
                    self.service.params = params
        if threshold is not _UNSET:
            value = None if threshold is None else float(threshold)
            if self.service is not None:
                self.service.threshold = value
            else:
                self._threshold = value
        if self.durability is not None:
            # resumption tokens carry the recalibration epoch so a client
            # can tell its scores straddled a swap (state itself is
            # carried through unchanged, same as for live sessions)
            self.durability.epoch += 1
        self.telemetry.count("gateway.recalibrated")
        self.events.emit(
            "recalibrate",
            threshold=self.threshold,
            params_swapped=params is not None,
        )
        return {"threshold": self.threshold, "params_swapped": params is not None}

    # -- observability ----------------------------------------------------

    def attach_event_log(self, path) -> EventLog:
        """Point the gateway's JSONL event log (lifecycle events + sampled
        spans) at ``path``; the tracer follows automatically.  Passing
        None detaches (back to the no-op log)."""
        old = self.events
        self.events = EventLog(path)
        self.tracer.events = self.events
        old.close()
        return self.events

    @property
    def placement(self) -> Placement:
        """The device placement the gateway's serving programs run on."""
        return self.engine.placement

    def stats(self) -> dict:
        """The telemetry snapshot in the reference's schema.  Host-side
        bookkeeping only, with no CUDA call, so a ``/metrics`` scrape thread
        may read it while the server's thread captures or replays."""
        out = self.telemetry.stats()
        out.update(
            schedule=self.engine.schedule.tag,
            capacity=self.pool.capacity,
            active_streams=self.pool.active,
            queue_depth=self.batcher.queue_depth,
            max_batch=self.batcher.max_batch,
            max_seq_len=self.batcher.max_seq_len,
            features=self.batcher.features,
            threshold=self.threshold,
        )
        # first-call visibility: per-program/per-shape first-call counts and
        # wall time from the engine, resolve-cache hit/miss from the registry
        out["engine"] = {
            **self.engine.profile_info(),
            "schedule_cache": schedule_cache_info(),
        }
        if self.placement.is_sharded:
            # the layout and live per-device residency; the per-flush fill
            # is the queue.device_fill gauge.  Absent under the single
            # placement, so single-device telemetry is unchanged
            out["placement"] = {
                **self.placement.describe(),
                "slots_per_device": self.pool.slots_per_device,
                "score_lanes": self.batcher.lanes,
                "device_active": self.pool.per_device_active(),
            }
        if self.durability is not None:
            out["durability"] = self.durability.describe()
        if self.control is not None:
            out["control"] = self.control.describe()
        return out

    def __repr__(self) -> str:
        pl = f", placement={self.placement!r}" if self.placement.is_sharded else ""
        return (f"AnomalyGateway(schedule={self.engine.schedule.tag}, "
                f"capacity={self.pool.capacity}, active={self.pool.active}, "
                f"queue_depth={self.batcher.queue_depth}{pl})")


def drive_stream_churn(
    gateway: AnomalyGateway, windows, churn_every: int = 8
) -> tuple[dict, list]:
    """Demo/benchmark loop: stream N logical series through the pool.

    ``windows`` is (N, T, F); up to ``capacity`` streams are admitted, all
    residents step each timestep, and every ``churn_every`` steps the
    oldest resident is evicted for a waiting stream (late admits score
    their series' tail — slot churn, the behaviour under test).  Returns
    ``(finals, unserved)``: {stream index: final running error} for every
    served stream, plus the indices still waiting when the loop ran out
    of timesteps (only capacity + (T-1)//churn_every streams can be
    served) — callers must report those, not drop them silently.  Used by
    ``launch/serve --gateway`` and ``chip_smoke.py``; a real deployment
    drives admit/step/evict from its transport instead.
    """
    windows = np.asarray(windows, np.float32)
    n, t_len, _ = windows.shape
    resident = list(range(min(gateway.pool.capacity, n)))
    waiting = list(range(len(resident), n))
    finals: dict = {}
    for sid in resident:
        gateway.admit(sid)
    for t in range(t_len):
        gateway.step({sid: windows[sid, t] for sid in resident})
        if waiting and t and t % churn_every == 0:
            old = resident.pop(0)
            finals[old] = gateway.evict(old)
            nxt = waiting.pop(0)
            gateway.admit(nxt)
            resident.append(nxt)
    for sid in resident:
        finals[sid] = gateway.evict(sid)
    return finals, waiting


__all__ = [
    "AnomalyGateway",
    "drive_stream_churn",
    "GatewayOverloadedError",
    "MicroBatcher",
    "Placement",
    "PoolFullError",
    "SessionPool",
    "Telemetry",
    "Ticket",
    "UnknownStreamError",
    "bucket_for",
]
