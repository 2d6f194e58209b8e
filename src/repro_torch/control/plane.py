"""Control-plane wiring: config, per-gateway control, supervisor loop.

Copy of ``repro/control/plane.py``, on the port's ``core/latency.py``,
``gateway/queue.py`` and ``obs/``; it makes no CUDA call, so a
supervisor that runs a :class:`ControlLoop` never initialises CUDA.

Two deployment shapes share the same controllers:

* **In-process** (:class:`GatewayControl`, via :func:`enable_control`) —
  attaches to one :class:`~repro_torch.gateway.AnomalyGateway` exactly like
  durability does (``gateway.control``), gates ``submit()`` through the
  admission controller, and rides the transport's pump loop via
  :meth:`GatewayControl.maybe_tick` — no thread of its own, same
  single-owner discipline as the rest of the gateway.
* **Multi-worker** (:class:`ControlLoop`) — a supervisor-side daemon
  thread over a :class:`~repro_torch.gateway.workers.WorkerFront`: each tick it
  reads the front-aggregated ``stats()`` (merged histograms, windowed
  rates), runs the batching controller and the autoscaler, fans batching
  knobs out over the existing control pipes (the same path
  ``recalibrate`` takes), and scales the worker fleet with zero-drop
  drain on the way down.  Admission runs worker-side (each worker's
  gateway gets its own :class:`~repro_torch.control.admission.AdmissionController`
  from the factory), because shedding must happen where requests arrive.

Every decision — hold or act — is journaled to ``controller.jsonl``
(:class:`repro_torch.obs.events.EventLog` schema: ``{"ts", "kind":
"control_tick", "tick", "scope", "p95_ms", "slo_ms", "action",
"reason", ...}``) so an operator can replay exactly why the plane did
what it did.

Percentile sensing is *windowed*: telemetry histograms are lifetime
accumulators, so each tick diffs the current bucket counts against the
previous tick's snapshot and computes p95 over the delta — the
controller reacts to the last tick's traffic, not the whole run's.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

from repro_torch.core.latency import serving_floor_ms
from repro_torch.gateway.queue import bucket_for
from repro_torch.obs.events import EventLog
from repro_torch.obs.histogram import Histogram

from repro_torch.control.admission import AdmissionController
from repro_torch.control.autoscale import Autoscaler
from repro_torch.control.batching import BatchingController

CONTROLLER_LOG = "controller.jsonl"


@dataclass
class ControlConfig:
    """Declared operating point for the control plane.

    ``slo_p95_ms`` None disables the batching controller (admission and
    autoscaling can still run); ``priority_classes`` 1 keeps flat
    admission; ``autoscale_min``/``autoscale_max`` None disables the
    autoscaler.  ``worker_rps`` overrides the latency-model-derived
    per-worker capacity estimate; ``floor_timesteps`` picks the bucket
    shape the feedforward floor is computed for (default: the
    ``max_seq_len`` bucket, the conservative choice).
    """

    slo_p95_ms: Optional[float] = None
    tick_interval_s: float = 1.0
    priority_classes: int = 1
    tenant_rate: Optional[float] = None
    tenant_burst: Optional[float] = None
    autoscale_min: Optional[int] = None
    autoscale_max: Optional[int] = None
    worker_rps: Optional[float] = None
    floor_timesteps: Optional[int] = None
    arch: Optional[str] = None
    min_wait_ms: float = 0.25
    patience: int = 2
    cooldown_ticks: int = 2
    extra: dict = field(default_factory=dict)

    @property
    def autoscaling(self) -> bool:
        return self.autoscale_min is not None and self.autoscale_max is not None


def _delta_hist(cur: Mapping[int, int], prev: Mapping[int, int]) -> Histogram:
    """Histogram of the samples recorded between two bucket snapshots."""
    out = Histogram()
    for idx, n in cur.items():
        d = int(n) - int(prev.get(idx, 0))
        if d > 0:
            out.counts[int(idx)] = d
            out.count += d
    return out


def _estimate_worker_rps(cfg: ControlConfig, floor_ms: float, lanes: int) -> float:
    """Per-worker sustainable score rate: one full flush per compute
    floor, derated 50% for assemble/wire overheads the model excludes."""
    if cfg.worker_rps is not None:
        return float(cfg.worker_rps)
    per_flush_s = max(floor_ms, 1e-3) / 1e3
    return 0.5 * max(1, lanes) / per_flush_s


class GatewayControl:
    """In-process control: admission gate + pump-driven batching ticks."""

    def __init__(
        self,
        gateway,
        cfg: ControlConfig,
        *,
        events: Optional[EventLog] = None,
    ):
        self.gateway = gateway
        self.cfg = cfg
        self.events = events if events is not None else gateway.events
        clock = gateway.telemetry.now
        self._clock = clock
        self.admission = AdmissionController(
            classes=cfg.priority_classes,
            tenant_rate=cfg.tenant_rate,
            tenant_burst=cfg.tenant_burst,
            telemetry=gateway.telemetry,
            clock=clock,
        )
        self.batching: Optional[BatchingController] = None
        self.floor_ms = 0.0
        if cfg.slo_p95_ms is not None:
            t_floor = bucket_for(cfg.floor_timesteps
                                 or gateway.batcher.max_seq_len)
            self.floor_ms = serving_floor_ms(
                gateway.engine.cfg.lstm_ae, t_floor, arch=cfg.arch,
            )
            self.batching = BatchingController(
                slo_p95_ms=cfg.slo_p95_ms,
                floor_ms=self.floor_ms,
                lanes=gateway.batcher.lanes,
                min_wait_ms=cfg.min_wait_ms,
                patience=cfg.patience,
                cooldown_ticks=cfg.cooldown_ticks,
            )
            gateway.batcher.set_knobs(**self.batching.prior_knobs(
                gateway.batcher.max_batch, gateway.batcher.max_wait_ms,
            ))
        self.ticks = 0
        self.last_decision: Optional[dict] = None
        self._next_tick = clock() + cfg.tick_interval_s
        self._prev_req_counts: dict[int, int] = {}
        self._prev_fill = (0.0, 0.0)  # (batch.filled, batch.slots)

    # -- admission gate (called from gateway.submit) -----------------------

    def admit(self, priority=None, tenant=None) -> int:
        batcher = self.gateway.batcher
        return self.admission.admit(
            depth=batcher.queue_depth,
            max_queue=batcher.max_queue,
            priority=priority,
            tenant=tenant,
        )

    # -- tick loop (ridden by the transport's pump) ------------------------

    def maybe_tick(self, now: Optional[float] = None) -> Optional[dict]:
        now = self._clock() if now is None else now
        if now < self._next_tick:
            return None
        self._next_tick = now + self.cfg.tick_interval_s
        return self.tick()

    def tick(self) -> dict:
        tel = self.gateway.telemetry
        self.ticks += 1
        req = tel.request_histogram
        window = _delta_hist(req.counts, self._prev_req_counts)
        self._prev_req_counts = dict(req.counts)
        filled = tel.counters.get("batch.filled", 0.0)
        slots = tel.counters.get("batch.slots", 0.0)
        d_filled = filled - self._prev_fill[0]
        d_slots = slots - self._prev_fill[1]
        self._prev_fill = (filled, slots)
        fill = (d_filled / d_slots) if d_slots else 0.0
        batcher = self.gateway.batcher
        decision: dict = {"action": "hold", "reason": "no_slo",
                          "knobs": None, "p95_ms": window.percentile(95),
                          "slo_ms": None}
        if self.batching is not None:
            decision = self.batching.decide(
                p95_ms=window.percentile(95),
                fill=fill,
                depth=batcher.queue_depth,
                arrival_rps=tel.windowed_rate("queue.submitted"),
                max_batch=batcher.max_batch,
                max_wait_ms=batcher.max_wait_ms,
            )
            if decision["knobs"]:
                decision["applied"] = batcher.set_knobs(**decision["knobs"])
        tel.count("control.ticks")
        self.last_decision = decision
        self.events.emit("control_tick", scope="gateway", tick=self.ticks,
                         **{k: v for k, v in decision.items() if k != "knobs"})
        return decision

    def describe(self) -> dict:
        out = {
            "ticks": self.ticks,
            "tick_interval_s": self.cfg.tick_interval_s,
            "slo_p95_ms": self.cfg.slo_p95_ms,
            "floor_ms": self.floor_ms,
            "admission": self.admission.describe(),
        }
        if self.batching is not None:
            out["batching"] = self.batching.describe()
        if self.last_decision is not None:
            out["last"] = {k: v for k, v in self.last_decision.items()
                           if k != "knobs"}
        return out


def enable_control(
    gateway,
    cfg: ControlConfig,
    *,
    event_dir: Optional[str] = None,
) -> GatewayControl:
    """Attach a control plane to one gateway (``gateway.control``), the
    same opt-in shape as ``enable_durability``.  ``event_dir`` points the
    decision journal at ``<event_dir>/controller.jsonl``; omitted, the
    gateway's own event log carries the ``control_tick`` records."""
    events = None
    if event_dir is not None:
        events = EventLog(os.path.join(os.fspath(event_dir), CONTROLLER_LOG))
    control = GatewayControl(gateway, cfg, events=events)
    gateway.control = control
    return control


class ControlLoop:
    """Supervisor-side control thread over a :class:`WorkerFront`.

    Owns nothing the workers own: it senses through ``front.stats()``
    (merged histograms, summed windowed rates), actuates batching through
    the ``control`` fan-out op, and actuates fleet size through
    ``front.scale_up()`` / ``front.scale_down()`` (drain-based, zero
    drop).  All cross-thread state is guarded by ``_lock`` — ``stats()``
    readers call :meth:`describe` from other threads.
    """

    def __init__(
        self,
        front,
        cfg: ControlConfig,
        *,
        lanes: int = 16,
        max_queue: int = 1024,
        model_cfg=None,
        event_dir: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.front = front
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.events = EventLog(
            os.path.join(os.fspath(event_dir), CONTROLLER_LOG)
            if event_dir is not None else None
        )
        self.floor_ms = 0.0
        if model_cfg is not None:
            t_floor = bucket_for(cfg.floor_timesteps or 64)
            self.floor_ms = serving_floor_ms(model_cfg, t_floor, arch=cfg.arch)
        self.batching: Optional[BatchingController] = None
        if cfg.slo_p95_ms is not None:
            self.batching = BatchingController(
                slo_p95_ms=cfg.slo_p95_ms,
                floor_ms=self.floor_ms,
                lanes=lanes,
                min_wait_ms=cfg.min_wait_ms,
                patience=cfg.patience,
                cooldown_ticks=cfg.cooldown_ticks,
            )
        self.autoscaler: Optional[Autoscaler] = None
        if cfg.autoscaling:
            self.autoscaler = Autoscaler(
                min_workers=cfg.autoscale_min,
                max_workers=cfg.autoscale_max,
                worker_rps=_estimate_worker_rps(cfg, self.floor_ms, lanes),
            )
        self.max_queue = int(max_queue)
        self.ticks = 0
        self.last_decision: Optional[dict] = None
        self._prev_req_counts: dict[int, int] = {}
        self._prev_fill = (0.0, 0.0)
        self._knobs: dict = {}
        # attach like enable_control does for a gateway: the front's
        # stats() picks up describe() and shutdown() stops the thread
        front.control = self

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ControlLoop":
        if self._thread is not None:
            raise RuntimeError("control loop already started")
        self._thread = threading.Thread(
            target=self._run, name="control-loop", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.events.close()

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.tick_interval_s):
            try:
                self.tick()
            except Exception:
                # the control plane must never take the data plane down
                import logging
                logging.getLogger(__name__).exception("control tick failed")

    # -- one tick ----------------------------------------------------------

    def tick(self, stats: Optional[Mapping] = None) -> dict:
        """Sense -> decide -> actuate once.  ``stats`` is injectable so
        tests and the benchmark can drive ticks without the thread."""
        s = dict(stats) if stats is not None else self.front.stats()
        hist = Histogram.from_dict(
            (s.get("histograms") or {}).get("request_ms")
        )
        with self._lock:
            self.ticks += 1
            tick_no = self.ticks
            window = _delta_hist(hist.counts, self._prev_req_counts)
            self._prev_req_counts = dict(hist.counts)
            counters = s.get("counters") or {}
            filled = counters.get("batch.filled", 0.0)
            slots = counters.get("batch.slots", 0.0)
            d_filled = filled - self._prev_fill[0]
            d_slots = slots - self._prev_fill[1]
            self._prev_fill = (filled, slots)
        fill = (d_filled / d_slots) if d_slots else 0.0
        p95 = window.percentile(95)
        arrival = float(s.get("arrival_rps_window", 0.0))
        depth = int(s.get("queue_depth", 0))
        workers_sec = s.get("workers") or {}
        n_workers = int(workers_sec.get("count", 0) or 0)
        decision: dict = {"p95_ms": p95, "slo_ms": self.cfg.slo_p95_ms,
                          "action": "hold", "reason": "no_slo"}

        if self.batching is not None:
            with self._lock:
                knobs = dict(self._knobs)
            b = self.batching.decide(
                p95_ms=p95, fill=fill, depth=depth, arrival_rps=arrival,
                max_batch=int(knobs.get("max_batch", 0))
                or int(s.get("max_batch", self.batching.lanes)),
                max_wait_ms=float(knobs.get("max_wait_ms", 0.0))
                or float(self.cfg.extra.get("max_wait_ms", 1.0)),
            )
            decision.update(b)
            if b["knobs"]:
                applied = self.front.set_batching(**b["knobs"])
                decision["applied"] = applied
                with self._lock:
                    self._knobs.update(b["knobs"])

        if self.autoscaler is not None:
            a = self.autoscaler.decide(
                arrival_rps=arrival, workers=max(n_workers, 1),
                queue_depth=depth, max_queue=self.max_queue,
            )
            decision["scale"] = {"delta": a["delta"], "reason": a["reason"],
                                 "utilization": a["utilization"]}
            if a["delta"] > 0:
                decision["scale"]["worker"] = self.front.scale_up()
            elif a["delta"] < 0:
                decision["scale"]["drain"] = self.front.scale_down()

        with self._lock:
            self.last_decision = decision
        self.events.emit(
            "control_tick", scope="front", tick=tick_no,
            **{k: v for k, v in decision.items() if k != "knobs"},
        )
        return decision

    def describe(self) -> dict:
        with self._lock:
            out = {
                "ticks": self.ticks,
                "tick_interval_s": self.cfg.tick_interval_s,
                "slo_p95_ms": self.cfg.slo_p95_ms,
                "floor_ms": self.floor_ms,
                "knobs": dict(self._knobs),
                "last": dict(self.last_decision or {}),
            }
        out["last"].pop("knobs", None)
        if self.batching is not None:
            out["batching"] = self.batching.describe()
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.describe()
        return out
