"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id>``.

Modes, as in the reference launcher:
- the LSTM-AE anomaly service (``repro_torch.engine.AnomalyService``) on a
  named execution schedule, printing the ``[serve]`` lines.  Request
  batches are drawn before the timed loop, so ms/request covers the
  host-to-device copy, the forward pass and the scores' return to the host;
- with ``--gateway``: the streaming gateway (``svc.open_gateway``) — a
  ``--capacity``-slot session pool with admit/evict churn over
  ``--streams`` logical streams, then a micro-batched one-shot request
  stream (``--max-batch`` / ``--max-wait-ms``), printing the ``[gateway]``
  lines and its telemetry;
- with ``--http``: the same gateway behind the socket transport
  (``repro_torch.gateway.server``: bp1 frames with per-connection JSON-lines
  fallback, a background pump, a graceful drain on SIGINT/SIGTERM that
  answers every pending ticket) on ``--host``/``--port``, printing the
  ``[http] listening on ...`` line when it serves and ``[http] drained:
  ...`` when it stops.  ``--store-dir`` serves durable sessions
  (snapshots every ``--snapshot-interval-ms`` and signed resumption
  tokens), ``--metrics-port`` serves ``GET /metrics`` and ``--event-dir``
  appends lifecycle events as JSONL.

With ``--train-steps N`` each mode first fits the service for N steps
on benign windows (``AnomalyService.fit``, batch 64 at ``--seq-len``),
calibrates its threshold on them and prints the ``fitted`` line.

The device defaults to the GPU and never falls back to the CPU:
``--device cpu`` asks for it.  Worker processes (``--workers``) and the
control plane (``--slo-p95-ms``, ``--priority-classes``, ``--tenant-rate``,
``--autoscale``, ``--control-tick-s``) are not ported yet; their flags exit
with an error that names the ``ROADMAP.md`` item that will port them.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import get_config, list_archs, reduced_config
from repro_torch.core.latency import PAPER_RH_M
from repro_torch.data import TimeseriesConfig, make_batch
from repro_torch.engine import AnomalyService, available_schedules

_ITEM_8 = "ROADMAP.md, queue 1, item 8 (multi-process workers)"
_ITEM_9 = "ROADMAP.md, queue 1, item 9 (control plane)"
NOT_PORTED = {
    "workers": _ITEM_8,
    "slo_p95_ms": _ITEM_9,
    "priority_classes": _ITEM_9,
    "tenant_rate": _ITEM_9,
    "autoscale": _ITEM_9,
    "control_tick_s": _ITEM_9,
}


def fit_and_calibrate(svc, args) -> dict:
    """Fit ``svc`` for ``--train-steps`` steps on benign windows, then
    calibrate its threshold on them; returns the final train metrics."""
    fit_cfg = TimeseriesConfig(features=svc.features, seq_len=args.seq_len, batch=64)
    metrics = svc.fit(fit_cfg, args.train_steps)
    svc.calibrate(fit_cfg)
    return metrics


def serve_lstm_ae(cfg, args) -> None:
    svc = AnomalyService(cfg, schedule=args.schedule, device=args.device)
    if args.train_steps:
        metrics = fit_and_calibrate(svc, args)
        print(f"[serve] fitted {cfg.name}: mse={metrics['mse']:.4f}, "
              f"threshold={svc.threshold:.4f}")
    data_cfg = TimeseriesConfig(features=cfg.lstm_ae.input_features,
                                seq_len=args.seq_len, batch=args.batch,
                                anomaly_rate=0.05)
    batches = [make_batch(data_cfg, i)[0] for i in range(args.requests)]
    svc.score(batches[0]).cpu()  # warm-up: kernel build and load, allocator
    total_alerts = 0
    t0 = time.perf_counter()
    for series in batches:
        errors = svc.score(series).cpu()
        if svc.threshold is not None:
            total_alerts += int((errors > svc.threshold).sum())
    dt = time.perf_counter() - t0
    steps = args.requests * args.batch * args.seq_len
    dev = svc.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    print(f"[serve] device {dev} ({name})")
    print(f"[serve] {cfg.name} [{svc.engine.schedule.tag}]: {args.requests} requests, "
          f"{dt/args.requests*1e3:.2f} ms/request, {steps/dt:,.0f} timesteps/s"
          + (f", alerts={total_alerts}" if svc.threshold is not None else ""))
    if cfg.name in PAPER_RH_M:  # Eq-1 is calibrated only for Table-1 archs
        est = svc.latency_model(args.seq_len)
        print(f"[serve] Eq-1 model ({est.schedule}) for one sequence "
              f"T={args.seq_len}: {est.ms:.3f} ms ({est.cycles} cycles)")


def serve_gateway(cfg, args) -> None:
    """Drive the streaming gateway: pooled sessions with churn + a
    micro-batched one-shot request stream, then print its telemetry."""
    from repro_torch.gateway import drive_stream_churn

    svc = AnomalyService(cfg, schedule=args.schedule, device=args.device)
    feats = cfg.lstm_ae.input_features
    if args.train_steps:
        fit_and_calibrate(svc, args)
        print(f"[gateway] fitted {cfg.name}: threshold={svc.threshold:.4f}")
    gw = svc.open_gateway(capacity=args.capacity, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms)
    dev = svc.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    print(f"[gateway] device {dev} ({name})")
    print(f"[gateway] {gw!r}")

    # --- streaming phase: more logical streams than slots, admit/evict churn
    n_streams = args.streams or 2 * args.capacity
    data_cfg = TimeseriesConfig(features=feats, seq_len=args.seq_len,
                                batch=n_streams, anomaly_rate=0.05, seed=7)
    xs = make_batch(data_cfg, 0)[0].numpy()          # (N, T, F)
    t0 = time.perf_counter()
    finals, unserved = drive_stream_churn(gw, xs)
    dt = time.perf_counter() - t0
    stepped = int(gw.stats()["counters"]["pool.stream_steps"])
    print(f"[gateway] streamed {len(finals)}/{n_streams} logical streams over "
          f"{gw.pool.capacity} slots: {stepped/dt:,.0f} stream-steps/s "
          f"({dt*1e3:.1f} ms wall)"
          + (f", {len(unserved)} still waiting at end" if unserved else ""))

    # --- one-shot phase: micro-batched score requests (mixed lengths)
    lens = [max(4, args.seq_len - (i % 3) * 2) for i in range(args.requests)]
    tickets = []
    for i, length in enumerate(lens):
        tickets.append(gw.submit(xs[i % n_streams, :length]))
        gw.pump()
    gw.flush()
    scores = np.array([t.score for t in tickets])
    # "is not None": a calibrated threshold of 0.0 is a real threshold
    alerts = int((scores > svc.threshold).sum()) if svc.threshold is not None else 0
    s = gw.stats()
    print(f"[gateway] scored {len(tickets)} one-shot requests "
          f"(fill={s['batch_fill_ratio']:.2f}, "
          f"p50={s['latency_ms']['p50']:.2f}ms, "
          f"p95={s['latency_ms']['p95']:.2f}ms)"
          + (f", alerts={alerts}" if svc.threshold is not None else ""))
    print(f"[gateway] stats: schedule={s['schedule']} "
          f"stream_steps_per_s={s['stream_steps_per_s']:,.0f} "
          f"requests_per_s={s['requests_per_s']:,.0f} "
          f"arrival_rps_window={s['arrival_rps_window']:,.0f} "
          f"rejected={s['counters'].get('queue.rejected', 0):.0f}")


def serve_http(cfg, args) -> None:
    """Serve the gateway over the socket transport until SIGINT/SIGTERM,
    then drain: every pending ticket is answered before the process exits."""
    from repro_torch.gateway.server import GatewayServer

    svc = AnomalyService(cfg, schedule=args.schedule, device=args.device)
    if args.train_steps:
        fit_and_calibrate(svc, args)
        print(f"[http] fitted {cfg.name}: threshold={svc.threshold:.4f}", flush=True)
    gw = svc.open_gateway(capacity=args.capacity, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms)
    if args.store_dir:
        from repro_torch.gateway.durability import enable_durability

        enable_durability(gw, args.store_dir,
                          snapshot_interval_ms=args.snapshot_interval_ms)
    if args.event_dir:
        gw.attach_event_log(os.path.join(args.event_dir, "server.jsonl"))
        gw.events.emit("boot", pid=os.getpid())
    metrics = None
    if args.metrics_port is not None:
        from repro_torch.obs import MetricsServer

        metrics = MetricsServer(gw.stats, host=args.host, port=args.metrics_port).start()
    server = GatewayServer(gw, host=args.host, port=args.port)

    def _ready(srv) -> None:
        durable = f", store={args.store_dir}" if args.store_dir else ""
        scrape = f" metrics_port={metrics.port}" if metrics else ""
        print(f"[http] listening on {srv.host}:{srv.port}{scrape} "
              f"protocols=bp1+json "
              f"(device={svc.device}, schedule={gw.engine.schedule.tag}, "
              f"capacity={gw.pool.capacity}, max_batch={gw.batcher.max_batch}, "
              f"max_wait_ms={gw.batcher.max_wait_ms}{durable})", flush=True)

    try:
        asyncio.run(server.run_until_signal(on_ready=_ready))
    finally:
        if metrics is not None:
            metrics.stop()
    s = gw.stats()
    print(f"[http] drained: {s['counters'].get('queue.completed', 0):.0f} one-shot "
          f"scores ({s['counters'].get('queue.failed', 0):.0f} failed, "
          f"{s['counters'].get('queue.rejected', 0):.0f} rejected), "
          f"{s['counters'].get('pool.stream_steps', 0):.0f} stream-steps over "
          f"{s['counters'].get('pool.admitted', 0):.0f} sessions", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--schedule", default="wavefront", choices=available_schedules(),
                    help="LSTM-AE execution schedule (engine registry name)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="fit the service for this many steps first (0: seeded init)")
    ap.add_argument("--gateway", action="store_true",
                    help="streaming gateway mode (session pool + micro-batched queue)")
    ap.add_argument("--capacity", type=int, default=32,
                    help="gateway: session-pool slots")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="gateway: micro-batch flush size")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="gateway: micro-batch max wait")
    ap.add_argument("--streams", type=int, default=0,
                    help="gateway: logical streams to churn (default 2x capacity)")
    ap.add_argument("--http", action="store_true",
                    help="serve the gateway over the socket transport (bp1 frames, "
                         "JSON-lines fallback) until SIGINT/SIGTERM")
    ap.add_argument("--host", default="127.0.0.1", help="--http: bind host")
    ap.add_argument("--port", type=int, default=0,
                    help="--http: bind port; 0 picks a free one (printed on the "
                         "'listening on' line)")
    ap.add_argument("--store-dir", default=None,
                    help="--http: durable sessions, snapshots and resumption tokens "
                         "in this directory")
    ap.add_argument("--snapshot-interval-ms", type=float, default=1000.0,
                    help="--http: snapshot cadence with --store-dir")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="--http: serve GET /metrics (Prometheus text) on this port; "
                         "0 picks a free one (printed as metrics_port=)")
    ap.add_argument("--event-dir", default=None,
                    help="--http: append lifecycle events as JSONL under this directory")
    ap.add_argument("--workers", type=int, default=0, help="not ported yet")
    ap.add_argument("--slo-p95-ms", type=float, default=None, help="not ported yet")
    ap.add_argument("--priority-classes", type=int, default=None, help="not ported yet")
    ap.add_argument("--tenant-rate", type=float, default=None, help="not ported yet")
    ap.add_argument("--autoscale", default=None, help="not ported yet")
    ap.add_argument("--control-tick-s", type=float, default=None, help="not ported yet")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    args = ap.parse_args(argv)

    for flag, item in NOT_PORTED.items():
        # --workers 0 is the single-process default; a control flag set to
        # anything, 0 included, asks for the control plane
        if getattr(args, flag) != (0 if flag == "workers" else None):
            ap.error(f"--{flag.replace('_', '-')} is not ported to repro_torch yet: {item}")
    resolve_device(args.device)  # fail before any work when no GPU is visible
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.http:
        serve_http(cfg, args)
    elif args.gateway:
        serve_gateway(cfg, args)
    else:
        serve_lstm_ae(cfg, args)


if __name__ == "__main__":
    main()
