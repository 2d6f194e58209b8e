"""Observability plane of the port: histograms, spans, the event log, /metrics.

Copies of ``repro/obs/{histogram,trace,events,prometheus}.py`` (pure
Python, no JAX), and the port's own spans inside its program.

* :mod:`repro_torch.obs.histogram` — mergeable log-linear latency
  histograms with fixed bucket boundaries.
* :mod:`repro_torch.obs.trace` — a :class:`Tracer` producing per-request
  spans of named stages, and :data:`PROGRAM`, the port's own nested spans
  inside its scoring path, recorded into histograms on request.
* :mod:`repro_torch.obs.events` — an append-only JSONL event log.
* :mod:`repro_torch.obs.prometheus` — Prometheus text exposition of
  ``gateway.stats()``-shaped dicts and a threaded ``/metrics`` endpoint
  (``launch/serve.py --http --metrics-port``).
"""
from repro_torch.obs.events import EventLog
from repro_torch.obs.histogram import Histogram, bucket_bound, bucket_index
from repro_torch.obs.prometheus import MetricsServer, render_stats
from repro_torch.obs.trace import PROGRAM, Span, Tracer

__all__ = [
    "EventLog",
    "Histogram",
    "MetricsServer",
    "PROGRAM",
    "Span",
    "Tracer",
    "bucket_bound",
    "bucket_index",
    "render_stats",
]
