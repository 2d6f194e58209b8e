"""Adaptive serving control plane: SLO-driven adaptive serving, the loop
closed from telemetry to knobs.

Copy of ``repro/control`` (pure Python, no JAX).  The paper fixes its
accelerator's operating point at synthesis time; SHARP (PAPERS.md)
argues an RNN accelerator should instead *adapt* its configuration to
the workload.  This package is that argument applied to the serving
tier: a declared p95 latency SLO plus three cooperating controllers that
read the gateway's sensors and actuate the knobs the stack already
exposes —

* :class:`~repro_torch.control.batching.BatchingController` — per-tick
  ``max_batch`` / ``max_wait_ms`` tuning with the
  :mod:`repro_torch.core.latency` model (the paper's FPGA) as feedforward
  prior, hysteresis, and bounded steps that never mint a new captured
  shape;
* :class:`~repro_torch.control.admission.AdmissionController` — priority
  classes over the flat overload error (shed lowest class first,
  per-class counters, per-tenant token buckets);
* :class:`~repro_torch.control.autoscale.Autoscaler` — worker count between
  declared min/max from windowed arrival rate and saturation, executed
  as zero-drop snapshot-handoff drains.

Wiring lives in :mod:`repro_torch.control.plane`: :func:`enable_control`
attaches a :class:`GatewayControl` to one in-process gateway (pump-
driven ticks), :class:`ControlLoop` runs supervisor-side over a
:class:`~repro_torch.gateway.workers.WorkerFront`.  Every decision is
journaled to ``controller.jsonl``.
"""
from repro_torch.control.admission import AdmissionController, TokenBucket
from repro_torch.control.autoscale import Autoscaler
from repro_torch.control.batching import BatchingController
from repro_torch.control.plane import (
    CONTROLLER_LOG,
    ControlConfig,
    ControlLoop,
    GatewayControl,
    enable_control,
)

__all__ = [
    "AdmissionController",
    "Autoscaler",
    "BatchingController",
    "CONTROLLER_LOG",
    "ControlConfig",
    "ControlLoop",
    "GatewayControl",
    "TokenBucket",
    "enable_control",
]
