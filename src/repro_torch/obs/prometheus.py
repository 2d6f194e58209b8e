"""Prometheus text exposition + a tiny threaded ``/metrics`` endpoint.

Counterpart of ``repro/obs/prometheus.py``; the metric names are the
reference's, so one scrape configuration reads either package.

:func:`render_stats` turns a ``gateway.stats()``-shaped dict (counters /
gauges / gauge_vecs / histograms plus a few scalar top-levels) into
Prometheus text format 0.0.4.  Metric names are ``repro_<name>`` with
dots mapped to underscores: ``queue.completed`` becomes
``repro_queue_completed_total``, the request histogram becomes
``repro_request_ms_bucket{le="..."}`` / ``_sum`` / ``_count``, and
vector gauges get a ``shard`` label per mesh position.  The same
renderer serves a single gateway, one worker, or the front-aggregated
view — ``WorkerFront.stats()`` has the same shape after histogram
merging.

:class:`MetricsServer` is a daemon-threaded ``http.server`` answering
``GET /metrics`` by calling a ``stats_fn`` and rendering it.  Port 0
binds an ephemeral port (the bound port is on ``.port`` and printed by
``launch/serve.py``); a stats failure answers 500 instead of killing
the scrape loop.
"""
from __future__ import annotations

import json
import logging
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping, Optional

from repro_torch.obs.histogram import Histogram

logger = logging.getLogger(__name__)

_PREFIX = "repro"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# scalar top-level stats() keys worth exposing as gauges
_SCALAR_GAUGES = (
    "uptime_s", "active_streams", "queue_depth", "capacity", "max_batch",
    "max_seq_len", "features", "threshold",
    "batch_fill_ratio", "mean_batch_wait_ms", "requests_per_s",
    "stream_steps_per_s", "workers",
    "arrival_rps_window", "completed_rps_window",
)


def _san(name: str) -> str:
    return _NAME_RE.sub("_", str(name))


def _labels(labels: Optional[Mapping[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_san(k)}="{str(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt(value: float) -> str:
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if v != int(v) else str(int(v))


def render_stats(
    stats: Mapping,
    *,
    labels: Optional[Mapping[str, str]] = None,
) -> str:
    """Render a stats dict as Prometheus text (one trailing newline)."""
    base = dict(labels or {})
    lines: list[str] = []

    def emit(name, kind, value, extra=None):
        metric = f"{_PREFIX}_{_san(name)}"
        lab = dict(base)
        if extra:
            lab.update(extra)
        lines.append(f"# TYPE {metric} {kind}")
        lines.append(f"{metric}{_labels(lab)} {_fmt(value)}")

    for key in _SCALAR_GAUGES:
        if key in stats and isinstance(stats[key], (int, float)):
            emit(key, "gauge", stats[key])
    workers = stats.get("workers")
    if isinstance(workers, Mapping):  # WorkerFront's aggregate section
        for key in ("count", "configured", "target", "restarts",
                    "scale_ups", "scale_downs",
                    "sessions_lost", "sessions_migrated"):
            if isinstance(workers.get(key), (int, float)):
                emit(f"workers_{key}", "gauge", workers[key])
    control = stats.get("control")
    if isinstance(control, Mapping):  # control-plane section
        for key in ("ticks", "tick_interval_s", "slo_p95_ms", "floor_ms"):
            if isinstance(control.get(key), (int, float)):
                emit(f"control_{key}", "gauge", control[key])
    for name, value in sorted((stats.get("counters") or {}).items()):
        emit(f"{name}_total", "counter", value)
    for name, value in sorted((stats.get("gauges") or {}).items()):
        emit(name, "gauge", value)
    for name, vec in sorted((stats.get("gauge_vecs") or {}).items()):
        metric = f"{_PREFIX}_{_san(name)}"
        lines.append(f"# TYPE {metric} gauge")
        for i, value in enumerate(vec):
            lab = dict(base)
            lab["shard"] = str(i)
            lines.append(f"{metric}{_labels(lab)} {_fmt(value)}")
    for name, data in sorted((stats.get("histograms") or {}).items()):
        hist = data if isinstance(data, Histogram) else Histogram.from_dict(data)
        metric = f"{_PREFIX}_{_san(name)}"
        lines.append(f"# TYPE {metric} histogram")
        for upper, cum in hist.cumulative():
            lab = dict(base)
            lab["le"] = _fmt(upper)
            lines.append(f"{metric}_bucket{_labels(lab)} {cum}")
        lines.append(f"{metric}_sum{_labels(base)} {_fmt(hist.sum)}")
        lines.append(f"{metric}_count{_labels(base)} {hist.count}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-metrics/1"

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] not in ("/metrics", "/metrics/"):
            self.send_error(404, "only /metrics is served here")
            return
        try:
            # the scrape thread reads telemetry dicts the serving loop
            # mutates; a concurrent insert raises "dict changed size
            # during iteration" — retry the snapshot, don't 500
            for attempt in range(3):
                try:
                    stats = self.server.stats_fn()  # type: ignore[attr-defined]
                    body = render_stats(
                        stats,
                        labels=self.server.metric_labels,  # type: ignore[attr-defined]
                    ).encode()
                    break
                except RuntimeError:
                    if attempt == 2:
                        raise
            status, ctype = 200, "text/plain; version=0.0.4; charset=utf-8"
        except Exception as exc:  # scrape must not take serving down
            logger.exception("stats render failed")
            body = json.dumps({"error": type(exc).__name__,
                               "message": str(exc)}).encode()
            status, ctype = 500, "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-scrape stderr noise
        pass


class MetricsServer:
    """Threaded ``GET /metrics`` endpoint over a ``stats_fn``."""

    def __init__(
        self,
        stats_fn: Callable[[], Mapping],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        labels: Optional[Mapping[str, str]] = None,
    ):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.stats_fn = stats_fn  # type: ignore[attr-defined]
        self._httpd.metric_labels = dict(labels or {})  # type: ignore[attr-defined]
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name=f"metrics:{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __repr__(self) -> str:
        return f"MetricsServer(http://{self.host}:{self.port}/metrics)"
