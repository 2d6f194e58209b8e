"""Observability plane of the port: histograms, spans, the event log.

Copies of ``repro/obs/{histogram,trace,events}.py`` (pure Python, no JAX);
the Prometheus exposition (``repro/obs/prometheus.py``) waits for the
transport slice.

* :mod:`repro_torch.obs.histogram` — mergeable log-linear latency
  histograms with fixed bucket boundaries.
* :mod:`repro_torch.obs.trace` — a :class:`Tracer` producing per-request
  spans of named stages.
* :mod:`repro_torch.obs.events` — an append-only JSONL event log.
"""
from repro_torch.obs.events import EventLog
from repro_torch.obs.histogram import Histogram, bucket_bound, bucket_index
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "EventLog",
    "Histogram",
    "Span",
    "Tracer",
    "bucket_bound",
    "bucket_index",
]
