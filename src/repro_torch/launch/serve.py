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
  appends lifecycle events as JSONL;
- with ``--workers N`` (implies ``--http``): the multi-worker front
  (``repro_torch.gateway.workers``) — N spawned worker processes share one
  ``SO_REUSEPORT`` port, each with its own engine and CUDA context on the
  current device (``cuda:0``; ``--device`` reaches every worker's
  factory, and ``--mesh data=K`` gives each worker a K-way placement); the
  supervisor respawns crashes and coordinates the SIGTERM
  drain, printing ``[workers] listening on ...`` when every worker serves
  and ``[workers] drained: ...`` (clean exits, dropped tickets) when it
  stops.  ``--store-dir`` makes the front durable (a snapshot shard per
  worker, resume on any worker).

``--slo-p95-ms``, ``--priority-classes``, ``--tenant-rate`` and, with
``--workers``, ``--autoscale MIN:MAX`` run the adaptive control plane
(``repro_torch.control``) every ``--control-tick-s``: SLO-driven batching
knobs, priority-aware admission (the highest class number sheds first)
and drain-based worker autoscaling.  Admission runs in each worker; the
batching controller and the autoscaler run in the supervisor.

With ``--train-steps N`` each mode first fits the service for N steps
on benign windows (``AnomalyService.fit``, batch 64 at ``--seq-len``),
calibrates its threshold on them and prints the ``fitted`` line.

``--mesh data=N`` lays every mode's engine out on ``Placement.data(N)``:
pool slots and micro-batch rows split over N devices, the visible GPUs
(fewer than N raise), or with ``--device cpu`` N emulated CPU devices (the
counterpart of the reference's ``XLA_FLAGS`` device-count passthrough).
The ready lines then print ``mesh=Nxdata``.

An LM arch (``--arch tinyllama-1.1b``; the transformers, dense and MoE,
``rwkv6-7b``, ``jamba-v0.1-52b`` and ``whisper-large-v3``) runs
``serve_lm``: params drawn on the device from seed 0, random prompt
tokens (``--batch`` x ``--seq-len``; under the vision stub also random
patch embeddings) from seed 1, for Whisper random bf16 frames
(``--batch`` x ``encoder_seq_len`` x ``d_model``) from seed 2, a
prefill, the prefill's cache stitched into a decode cache of every
position the prefill covered plus ``--decode-tokens`` (RWKV-6: the
prefill's recurrent state as it is; Whisper: its self-KV stitched, its
cross-KV of the frames as it is), then greedy decoding from there with the
decode step captured into a CUDA graph (``serving.GreedyDecoder``; the
CPU runs it eagerly).  It prints the reference's two ``[serve]`` lines.
The reference decodes against a zeroed cache or state instead, for
Whisper a zeroed cross-KV, so its continuation never sees the frames
(ROADMAP.md, queue 3); the port's decodes from the prefill's.
``--gateway``, ``--http``, ``--workers`` and ``--mesh`` serve the LSTM-AE
only and refuse an LM arch.

The device defaults to the GPU and never falls back to the CPU:
``--device cpu`` asks for it.
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
from repro_torch.engine import AnomalyService, EngineConfig, Placement, available_schedules
from repro_torch.models import build_model
from repro_torch.serving import GreedyDecoder, build_prefill_step, stitch_prefill_cache


def engine_cfg_for(args):
    """The engine selection for this invocation: the bare schedule name,
    or a full EngineConfig carrying the ``--mesh`` placement (e.g.
    ``--mesh data=2`` splits pool slots and micro-batch rows 2-way)."""
    if not args.mesh:
        return args.schedule
    return EngineConfig(schedule=args.schedule, placement=Placement.from_spec(args.mesh))


def mesh_ways(args) -> int:
    """Data shards per engine that ``--mesh`` asks for (1 without it)."""
    return Placement.from_spec(args.mesh).data_shards if args.mesh else 1


def parse_autoscale(spec):
    """``--autoscale MIN:MAX`` -> ``(min, max)`` worker bounds (or None)."""
    if not spec:
        return None
    try:
        lo, hi = (int(p) for p in spec.split(":", 1))
    except ValueError:
        raise SystemExit(f"--autoscale expects MIN:MAX, got {spec!r}")
    if lo < 1 or hi < lo:
        raise SystemExit(f"--autoscale needs 1 <= MIN <= MAX, got {spec!r}")
    return lo, hi


def control_cfg_for(args, *, autoscale=None):
    """The :class:`repro_torch.control.ControlConfig` this invocation asked
    for, or None when no control-plane flag is set (flat admission, static
    knobs, fixed fleet)."""
    wants = (args.slo_p95_ms is not None or args.priority_classes > 1
             or args.tenant_rate is not None or autoscale is not None)
    if not wants:
        return None
    from repro_torch.control import ControlConfig

    return ControlConfig(
        slo_p95_ms=args.slo_p95_ms,
        tick_interval_s=args.control_tick_s,
        priority_classes=args.priority_classes,
        tenant_rate=args.tenant_rate,
        autoscale_min=autoscale[0] if autoscale else None,
        autoscale_max=autoscale[1] if autoscale else None,
        floor_timesteps=args.seq_len,
        arch=args.arch,
        extra={"max_wait_ms": args.max_wait_ms},
    )


def fit_and_calibrate(svc, args) -> dict:
    """Fit ``svc`` for ``--train-steps`` steps on benign windows, then
    calibrate its threshold on them; returns the final train metrics."""
    fit_cfg = TimeseriesConfig(features=svc.features, seq_len=args.seq_len, batch=64)
    metrics = svc.fit(fit_cfg, args.train_steps)
    svc.calibrate(fit_cfg)
    return metrics


def serve_lstm_ae(cfg, args) -> None:
    svc = AnomalyService(cfg, schedule=engine_cfg_for(args), device=args.device)
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

    svc = AnomalyService(cfg, schedule=engine_cfg_for(args), device=args.device)
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

    svc = AnomalyService(cfg, schedule=engine_cfg_for(args), device=args.device)
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
    ccfg = control_cfg_for(args)
    if ccfg is not None:
        from repro_torch.control import enable_control

        enable_control(gw, ccfg, event_dir=args.event_dir or None)
    metrics = None
    if args.metrics_port is not None:
        from repro_torch.obs import MetricsServer

        metrics = MetricsServer(gw.stats, host=args.host, port=args.metrics_port).start()
    server = GatewayServer(gw, host=args.host, port=args.port)

    def _ready(srv) -> None:
        mesh = (f", mesh={gw.placement.data_shards}x{gw.placement.data_axis}"
                if gw.placement.is_sharded else "")
        durable = f", store={args.store_dir}" if args.store_dir else ""
        control = ""
        if gw.control is not None:
            control = (f", slo_p95_ms={args.slo_p95_ms}, "
                       f"priority_classes={args.priority_classes}")
        scrape = f" metrics_port={metrics.port}" if metrics else ""
        print(f"[http] listening on {srv.host}:{srv.port}{scrape} "
              f"protocols=bp1+json "
              f"(device={svc.device}, schedule={gw.engine.schedule.tag}, "
              f"capacity={gw.pool.capacity}, max_batch={gw.batcher.max_batch}, "
              f"max_wait_ms={gw.batcher.max_wait_ms}{mesh}{durable}{control})", flush=True)

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


def serve_workers(cfg, args) -> None:
    """Run the multi-worker front: ``--workers N`` processes behind one
    ``SO_REUSEPORT`` port until SIGINT/SIGTERM, then the coordinated drain
    with a per-worker summary (every worker exits cleanly, zero dropped).

    The per-worker build is ``workers.default_gateway_factory`` (it runs IN
    each worker, on ``--device``; with ``--train-steps`` every worker fits
    from the same seed on its own device, so all workers serve the same
    params without shipping arrays across processes).  The supervisor
    makes no CUDA call.  ``--mesh data=K`` lays each worker's engine out on
    a K-way placement of its own devices (``default_gateway_factory``)."""
    import functools

    from repro_torch.gateway.workers import WorkerFront, default_gateway_factory

    ways = mesh_ways(args)
    autoscale = parse_autoscale(args.autoscale)
    n_workers = args.workers
    if autoscale:
        # start inside the declared bounds; the autoscaler moves from here
        n_workers = min(max(n_workers, autoscale[0]), autoscale[1])
    front = WorkerFront(
        functools.partial(
            default_gateway_factory, args.arch, args.schedule,
            reduced=args.reduced, train_steps=args.train_steps,
            train_seq_len=args.seq_len, capacity=args.capacity,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            mesh=ways, warm_seq_len=args.seq_len,
            priority_classes=args.priority_classes,
            tenant_rate=args.tenant_rate, device=args.device,
        ),
        n_workers=n_workers, host=args.host, port=args.port,
        store_dir=args.store_dir or None,
        snapshot_interval_ms=args.snapshot_interval_ms,
        event_dir=args.event_dir or None,
        metrics_port=args.metrics_port,
    )
    ccfg = control_cfg_for(args, autoscale=autoscale)
    loop = None
    if ccfg is not None and (ccfg.slo_p95_ms is not None or ccfg.autoscaling):
        from repro_torch.control import ControlLoop

        loop = ControlLoop(front, ccfg, lanes=args.max_batch,
                           model_cfg=cfg.lstm_ae,
                           event_dir=args.event_dir or None)

    def _ready(f) -> None:
        scrape = f" metrics_port={f.metrics.port}" if f.metrics else ""
        control = ""
        if loop is not None:
            loop.start()
            bounds = (f" autoscale={autoscale[0]}:{autoscale[1]}"
                      if autoscale else "")
            control = (f" slo_p95_ms={args.slo_p95_ms}{bounds} "
                       f"priority_classes={args.priority_classes}")
        print(f"[workers] listening on {f.host}:{f.port}{scrape} "
              f"protocols=bp1+json workers={n_workers} mesh={ways}xdata "
              f"(schedule={args.schedule}, capacity={args.capacity} and "
              f"max_batch={args.max_batch} per worker){control}", flush=True)

    summary = front.run_until_signal(on_ready=_ready)
    c = summary["counters"]
    print(f"[workers] drained: {summary['clean_exits']}/{summary['workers']} "
          f"workers exited cleanly, {summary['dropped_tickets']} dropped "
          f"tickets, {c.get('queue.completed', 0):.0f} one-shot scores "
          f"({c.get('queue.failed', 0):.0f} failed, "
          f"{c.get('queue.rejected', 0):.0f} rejected), "
          f"{c.get('pool.stream_steps', 0):.0f} stream-steps over "
          f"{c.get('pool.admitted', 0):.0f} sessions, "
          f"restarts={summary['restarts']}, "
          f"sessions_migrated={summary.get('sessions_migrated', 0)}, "
          f"sessions_lost={summary['sessions_lost']}", flush=True)


FRAMES_SEED = 2     # the reference's PRNGKey(2) for Whisper's frames


def serve_lm(cfg, args) -> None:
    """Prefill a random prompt batch, then greedy-decode ``--decode-tokens``
    tokens against the prefill's own KV cache (RWKV-6: from the prefill's
    own recurrent state; Jamba: from its KV cache and Mamba states;
    Whisper: from its self-KV and the cross-KV of its frames; the
    reference decodes each from zeros)."""
    device = resolve_device(args.device)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0), device=device)
    b, s = args.batch, args.seq_len
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=device, dtype=torch.int32)}
    if cfg.family == "whisper":
        batch["frames"] = torch.randn(
            (b, cfg.encoder_seq_len, cfg.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(FRAMES_SEED)).to(torch.bfloat16)
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = torch.randn((b, cfg.vision_patches, cfg.d_model),
                                            generator=gen, device=device).to(torch.bfloat16)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    logits, prefill_cache = build_prefill_step(api)(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0

    # the positions the prompt filled: its tokens, plus the patches under the stub
    covered = s + (batch["image_embeds"].shape[1] if "image_embeds" in batch else 0)
    cache = stitch_prefill_cache(api, prefill_cache, covered + args.decode_tokens)
    del prefill_cache
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    sync()
    t0 = time.perf_counter()
    # in place: the step is captured over this cache, which nothing else reads
    decoder = GreedyDecoder(api, in_place=True)
    out_tokens, _ = decoder(params, cache, first, covered, args.decode_tokens)
    sync()
    t_decode = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"
    print(f"[serve] device {device} ({name})")
    print(f"[serve] {cfg.name}: prefill({b}x{s})={t_prefill*1e3:.1f}ms, "
          f"{args.decode_tokens} tokens decoded in {t_decode*1e3:.1f}ms "
          f"({b*args.decode_tokens/t_decode:,.0f} tok/s)", flush=True)
    print(f"[serve] sample continuation: {out_tokens[0, :8].tolist()}", flush=True)


LSTM_AE_MODES = ("gateway", "http", "workers", "mesh")


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags (``main`` acts on them)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=16,
                    help="LM archs: tokens to greedy-decode after the prefill")
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
    ap.add_argument("--workers", type=int, default=0,
                    help="spawn N gateway worker processes sharing one SO_REUSEPORT "
                         "port (implies --http), each with its own engine")
    ap.add_argument("--slo-p95-ms", type=float, default=None,
                    help="declare a p95 one-shot-latency SLO (ms): the control plane "
                         "tunes max_batch/max_wait_ms each tick to meet it")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="admission priority classes (1 = flat admission); under "
                         "overload the HIGHEST class number sheds first")
    ap.add_argument("--tenant-rate", type=float, default=None,
                    help="per-tenant token-bucket admission rate (requests/s)")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="with --workers: scale the fleet between MIN and MAX workers "
                         "from the arrival rate and queue saturation (scale-down is a "
                         "zero-drop drain)")
    ap.add_argument("--control-tick-s", type=float, default=1.0,
                    help="control-plane tick interval (seconds)")
    ap.add_argument("--mesh", default=None, metavar="data=N",
                    help="lay pool slots and micro-batch rows out over N devices "
                         "(the visible GPUs; with --device cpu, N emulated CPU "
                         "devices); with --workers, per worker")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    args = ap.parse_args(argv)
    if args.mesh:
        try:
            Placement.from_spec(args.mesh)
        except ValueError as exc:
            ap.error(str(exc))
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family != "lstm_ae":
        asked = [f"--{m}" for m in LSTM_AE_MODES if getattr(args, m)]
        if asked:
            raise SystemExit(f"{' '.join(asked)}: LSTM-AE serving only; {args.arch} is a "
                             f"{cfg.family} LM, served by prefill and greedy decoding")
    # fail before any work when no GPU is visible; the supervisor of
    # --workers checks without initialising CUDA (its workers use the card)
    if not args.workers:
        resolve_device(args.device)
    elif args.device is None or torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            resolve_device(args.device)  # raises, naming --device cpu
    if cfg.family != "lstm_ae":
        serve_lm(cfg, args)
    elif args.workers:
        serve_workers(cfg, args)
    elif args.http:
        serve_http(cfg, args)
    elif args.gateway:
        serve_gateway(cfg, args)
    else:
        serve_lstm_ae(cfg, args)


if __name__ == "__main__":
    main()
