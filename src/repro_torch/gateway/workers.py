"""Multi-worker gateway front: N processes behind ONE listening port.

Counterpart of ``repro/gateway/workers.py``.  The paper's accelerator
replicates compute tiles until the datapath — not any one module — sets
throughput; the serving analogue is the transport tier.
:class:`~repro_torch.gateway.server.GatewayServer` runs everything on one
asyncio loop in one process, so past a point the Python transport
(framing + the GIL), not the captured step on the GPU, is the ceiling.
:class:`WorkerFront` removes that ceiling the same way the hardware does
— by replication:

* **One port, N acceptors** — the front reserves a port with
  ``SO_REUSEPORT`` (bound, never listening, so the ephemeral port
  survives worker churn) and forks N worker processes that each bind the
  same address and ``listen()``; the kernel load-balances incoming
  connections across the listening sockets.  Every worker runs the same
  :class:`GatewayServer` code, so the wire behaviour is byte-identical
  across workers — bp1 binary frames for clients that negotiate them,
  the JSON-lines protocol as per-connection fallback — and clients
  cannot tell one worker from eight (negotiation happens per connection,
  after the kernel has already picked the worker).
* **One engine per worker** — each worker builds its own
  ``AnomalyGateway`` (own ``Engine``, own CUDA context, own captured
  programs) in its own process, so kernel launches, frame parsing and
  the event loop all run N-way parallel with no shared GIL.  Workers
  that share one GPU time-slice it (no MPS): replication wins back host
  time, not device time.
* **A tiny supervisor** — the parent process watches worker sentinels
  and respawns crashed workers on the same port (``restarts`` /
  ``sessions_lost`` account what the crash cost: the victim's
  last-heartbeat resident-session count), fans ``stats`` /
  ``recalibrate`` out over per-worker control pipes, and coordinates
  SIGTERM drain — every worker answers all pending tickets before exit
  and reports a drain summary (``dropped_tickets`` must be 0).

Control-plane message shapes (one ``multiprocessing.Pipe`` per worker):

  supervisor -> worker   ``{"id", "op": stats|recalibrate|control|
                         shutdown|ping, "kw": {...}}`` ->
                         ``{"id", "result"|"error"}``
  worker -> supervisor   ``{"event": ready|heartbeat|drained|error, ...}``
                         and ``{"wid", "op": aggregate|recalibrate_all,
                         "kw"}`` -> ``{"wid", "result"|"error"}`` — how a
                         wire-level ``stats``/``recalibrate`` request
                         received by ONE worker becomes a front-wide
                         fan-out (see ``GatewayServer.stats_provider``).

Session affinity is per-connection (the connection IS the stream, and a
connection lives on one worker), but with ``store_dir`` set the front is
DURABLE: every worker snapshots its pool block into its own shard of one
shared :class:`~repro_torch.gateway.durability.SessionStore`, step responses
carry signed resumption tokens, a respawned worker adopts its dead
predecessor's snapshot shard, and clients revive a crashed worker's
streams on any other worker via ``resume`` — so ``sessions_lost`` counts
only what durability explicitly does not cover.  Coordinated drain takes
a handoff snapshot per worker first: the summary's
``sessions_migrated``/``sessions_lost`` account every resident stream.

``device_claims`` gives each worker its own CUDA device, as an enforced
invariant instead of a convention: the supervisor validates the claim
map (``{worker index: ["cuda:N"]}``) for overlap before spawning
anything, and each worker registers its claim in the store's
:class:`~repro_torch.gateway.claims.DeviceClaimRegistry` at boot — two
workers claiming one device is a boot error naming both — then makes
the claimed device its current CUDA device before it builds its
gateway, so ``device=None`` resolves to it.  A claim of several GPUs with
``default_gateway_factory(mesh=K)`` lays the worker's data placement over
its first K.  Without a claim every worker takes the current device of a
fresh process, ``cuda:0``.

Workers are spawned (not forked): a process that has initialised CUDA
must never be forked, and ``env`` overrides (e.g.
``CUDA_VISIBLE_DEVICES``) are applied to the environment the child boots
with.  Nothing crosses a pipe as a tensor: ``import torch`` makes a
tensor pickle as a shared-memory handle (a CUDA one as an IPC handle
the sender must keep alive), so params travel as numpy arrays and stats
as plain Python.  The supervisor makes no CUDA call of its own.
"""
from __future__ import annotations

import itertools
import logging
import multiprocessing as mp
import os
import signal
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.gateway.claims import (
    DeviceClaimRegistry,
    claimed_cuda_index,
    process_claim,
    set_process_claim,
    validate_disjoint,
)
from repro_torch.gateway.telemetry import REQUEST_HIST
from repro_torch.obs import EventLog, Histogram, MetricsServer
from repro_torch.utils import params_from_numpy, params_to_numpy

logger = logging.getLogger(__name__)

_UNSET = object()


# ---------------------------------------------------------------------------
# worker process side
# ---------------------------------------------------------------------------


class _WorkerControl:
    """Worker-side end of the control pipe, living on the worker's event
    loop (``add_reader`` — no extra thread, so gateway calls stay on the
    loop and the single-threaded gateway contract holds)."""

    def __init__(self, conn, gateway, stop_event):
        self.conn = conn
        self.gateway = gateway
        self.stop_event = stop_event
        self._loop = None
        self._wid = itertools.count()
        self._futures: dict = {}

    def install(self, loop) -> None:
        self._loop = loop
        loop.add_reader(self.conn.fileno(), self._on_readable)

    def uninstall(self) -> None:
        if self._loop is not None:
            self._loop.remove_reader(self.conn.fileno())

    def send(self, msg: dict) -> None:
        try:
            self.conn.send(msg)
        except (BrokenPipeError, OSError):  # supervisor is gone; a drain
            pass                            # is already on its way

    def _on_readable(self) -> None:
        try:
            while self.conn.poll():
                self._handle(self.conn.recv())
        except (EOFError, OSError):
            # supervisor hung up: shut down rather than serve unowned
            self.stop_event.set()

    def _handle(self, msg: dict) -> None:
        if "wid" in msg:  # reply to a worker-initiated request
            fut = self._futures.pop(msg["wid"], None)
            if fut is not None and not fut.done():
                if "error" in msg:
                    fut.set_exception(RuntimeError(msg["error"]))
                else:
                    fut.set_result(msg["result"])
            return
        rid, op, kw = msg.get("id"), msg.get("op"), msg.get("kw", {})
        try:
            if op == "stats":
                result = self.gateway.stats()  # LOCAL stats: the supervisor
            elif op == "recalibrate":          # does the aggregation
                if kw.get("params") is not None:
                    # params crossed the pipe as numpy leaves; land them on
                    # this worker's device once here (Engine.bind then
                    # writes them into its captured copy in place), so the
                    # hot pool step never pays a per-call transfer
                    kw = dict(kw)
                    kw["params"] = params_from_numpy(
                        kw["params"], device=self.gateway.engine.device)
                result = self.gateway.recalibrate(**kw)
            elif op == "control":
                # batching-knob fan-out from the supervisor's control
                # loop; same path recalibrate takes, applied to the
                # batcher (clamped to the captured lane count)
                result = self.gateway.batcher.set_knobs(**kw)
            elif op == "shutdown":
                self.stop_event.set()
                result = {"ok": True}
            elif op == "ping":
                result = {"ok": True}
            else:
                raise ValueError(f"unknown control op {op!r}")
            self.send({"id": rid, "result": result})
        except Exception as exc:
            self.send({"id": rid, "error": f"{type(exc).__name__}: {exc}"})

    async def supervisor_request(self, op: str, timeout: float = 25.0, **kw):
        """Ask the supervisor for a front-wide operation (aggregate stats,
        fan-out recalibrate) and await its reply.  The default timeout
        sits ABOVE the supervisor's concurrent per-worker fan-out budget
        (15s, see ``WorkerFront._request``) so a slow sibling degrades to
        the supervisor's partial answer, not to this worker silently
        falling back mid-fan-out."""
        import asyncio

        wid = next(self._wid)
        fut = self._loop.create_future()
        self._futures[wid] = fut
        self.send({"wid": wid, "op": op, "kw": kw})
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._futures.pop(wid, None)


def _worker_main(index: int, conn, host: str, port: int,
                 factory: Callable, heartbeat_s: float,
                 durability: Optional[dict] = None,
                 claim: Optional[dict] = None,
                 obs: Optional[dict] = None) -> None:
    """Entry point of one worker process: register the device claim and
    make its device current, build the gateway, attach durability and the
    observability plane (per-worker event log + /metrics endpoint), serve
    the shared port, heartbeat, drain on SIGTERM/shutdown, report a
    summary."""
    import asyncio

    # factory() builds the engine and captures programs — seconds during
    # which a coordinated drain's SIGTERM would hit the default disposition
    # and kill the worker uncleanly.  Flag boot-phase signals and honour them
    # the moment the event loop takes over signal handling.
    boot_stop = threading.Event()
    for _sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(_sig, lambda *_: boot_stop.set())

    from repro_torch.gateway.server import GatewayServer

    owner = f"worker-{index}"
    obs = obs or {}
    metrics = None
    try:
        if claim:
            # validate-at-boot, BEFORE the expensive factory work: an
            # overlapping claim fails the spawn with the registry's error
            DeviceClaimRegistry(claim["dir"]).claim(owner, claim["devices"])
            set_process_claim(claim["devices"])
            cuda_index = claimed_cuda_index(claim["devices"])
            if cuda_index is not None:
                # before factory(): resolve_device(None) takes the current
                # device, and the server's loop (this thread) keeps it
                torch.cuda.set_device(cuda_index)
        gateway = factory()
        if durability:
            from repro_torch.gateway.durability import enable_durability

            enable_durability(gateway, shard=owner, **durability)
        if obs.get("event_dir"):
            gateway.attach_event_log(
                os.path.join(obs["event_dir"], f"{owner}.jsonl"))
            gateway.events.emit("boot", worker=index, pid=os.getpid())
        if obs.get("metrics_port") is not None:
            # deterministic ladder off the supervisor's base port; a base
            # of 0 means every endpoint binds ephemerally (the bound port
            # travels back on the ready event)
            base = int(obs["metrics_port"])
            want = 0 if base == 0 else base + 1 + index
            try:
                metrics = MetricsServer(
                    gateway.stats, port=want,
                    labels={"worker": str(index)},
                ).start()
            except OSError as exc:
                # a scrape endpoint must never cost us an acceptor
                logger.warning("worker %d: /metrics bind on port %d failed "
                               "(%s); serving without metrics", index, want,
                               exc)
    except BaseException as exc:
        try:
            conn.send({"event": "error",
                       "message": f"{type(exc).__name__}: {exc}"})
        except Exception:
            pass
        raise

    async def _loop() -> None:
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        control = _WorkerControl(conn, gateway, stop)

        async def _stats_provider():
            # a wire-level "stats" landing on THIS worker answers for the
            # whole front: the supervisor fans out to every worker (this
            # one replies its local stats from the pipe reader while this
            # coroutine awaits) and returns the aggregate.  If the
            # supervisor cannot answer, fall back to local stats rather
            # than failing the request.
            try:
                return await control.supervisor_request("aggregate")
            except Exception:
                logger.exception("worker %d: stats aggregation failed; "
                                 "answering local stats", index)
                return gateway.stats()

        async def _recalibrate_provider(**kw):
            # recalibrate must hit EVERY worker or thresholds diverge
            # across acceptors; no local fallback — a partial recalibrate
            # is worse than a failed one.
            return await control.supervisor_request("recalibrate_all", **kw)

        server = GatewayServer(
            gateway, host=host, port=port, reuse_port=True,
            stats_provider=_stats_provider,
            recalibrate_provider=_recalibrate_provider,
        )
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                signal.signal(sig, lambda *_: stop.set())
        if boot_stop.is_set():  # a drain already asked for us mid-boot
            stop.set()
        control.install(loop)
        await server.start()
        control.send({"event": "ready", "index": index, "port": server.port,
                      "pid": os.getpid(),
                      "metrics_port": metrics.port if metrics else None})

        async def _heartbeat() -> None:
            while True:
                control.send({
                    "event": "heartbeat", "index": index,
                    "active": gateway.pool.active,
                    "queue_depth": gateway.batcher.queue_depth,
                })
                await asyncio.sleep(heartbeat_s)

        hb = loop.create_task(_heartbeat())
        await stop.wait()
        hb.cancel()
        active_before = gateway.pool.active
        await server.drain()  # durability: takes the handoff snapshot
        handoff = (gateway.durability.last_handoff
                   if gateway.durability is not None else None) or {}
        migrated = int(handoff.get("sessions_migrated", 0))
        counters = {k: float(v)
                    for k, v in gateway.stats()["counters"].items()}
        control.send({
            "event": "drained", "index": index,
            "summary": {
                "counters": counters,
                # the drain contract: nothing left unanswered
                "pending_after_drain": gateway.batcher.queue_depth,
                "active_before_drain": active_before,
                # the migration contract: with durability every resident
                # stream lands in the handoff snapshot (lost == 0)
                "sessions_migrated": migrated,
                "sessions_lost": max(0, active_before - migrated),
            },
        })
        control.uninstall()

    asyncio.run(_loop())
    if metrics is not None:
        try:
            metrics.stop()
        except Exception:
            logger.debug("worker %d: metrics server stop failed", index,
                         exc_info=True)
    if claim:
        try:
            DeviceClaimRegistry(claim["dir"]).release(owner)
        except Exception:
            logger.debug("worker %d: device-claim release failed (claim "
                         "may linger until reaped)", index, exc_info=True)


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------


def _exited(proc, timeout: float) -> bool:
    """Wait up to ``timeout`` for ``proc`` to exit; True once it has.

    Exit is read from the process's sentinel, which any number of threads
    may wait on, and not from ``Process.join`` alone: join reaps the child
    with ``waitpid``, and when two threads reap one child at once (the
    monitor thread and a drain, or a ``stats()`` reader's ``is_alive``) the
    loser gets ECHILD, which ``multiprocessing`` reports as "still
    running" — a clean drain would then read as a hung worker and be
    terminated.  After the sentinel fires, the exit code is read until
    whichever thread reaped the child has recorded it."""
    if not mp.connection.wait([proc.sentinel], timeout):
        return False
    settle = time.monotonic() + 2.0
    while proc.exitcode is None and time.monotonic() < settle:
        time.sleep(0.01)
    return True


class _Worker:
    """Supervisor-side record of one worker process (one generation)."""

    def __init__(self, index: int, proc, conn):
        self.index = index
        self.proc = proc
        self.conn = conn
        self.pid: Optional[int] = None
        self.metrics_port: Optional[int] = None
        self.ready = threading.Event()
        self.error: Optional[str] = None
        self.last_active = 0
        self.last_queue_depth = 0
        # set (under the front lock) the moment a scale-down picks this
        # worker: the monitor must not respawn its exit, and fan-outs /
        # stats must stop counting it BEFORE its SIGTERM lands
        self.scaling_down = False
        self.drain_summary: Optional[dict] = None
        self.exitcode: Optional[int] = None
        self.send_lock = threading.Lock()
        self.pending: dict = {}  # id -> [threading.Event, payload]

    def send(self, msg: dict) -> None:
        with self.send_lock:
            self.conn.send(msg)


class WorkerFront:
    """Supervise N ``GatewayServer`` worker processes behind one port.

    ``factory`` is called IN each worker process to build that worker's
    :class:`~repro_torch.gateway.AnomalyGateway` — it must be picklable
    under the ``spawn`` start method (a module-level function or a
    ``functools.partial`` of one), and spawn imports the module that
    defines it in every worker.  Each worker therefore owns a private
    engine on its own CUDA context; ``device_claims`` gives each its own
    card (``env`` overrides are applied to the child's boot environment,
    ahead of any CUDA initialisation).

    >>> front = WorkerFront(functools.partial(make_gateway), n_workers=4)
    >>> host, port = front.start()       # same wire protocol as one server
    >>> front.stats()                    # aggregated over the control pipes
    >>> summary = front.shutdown()       # coordinated drain; 0 dropped
    """

    def __init__(
        self,
        factory: Callable,
        *,
        n_workers: int = 2,
        host: str = "127.0.0.1",
        port: int = 0,
        env: Optional[dict] = None,
        heartbeat_ms: float = 250.0,
        respawn: bool = True,
        max_respawns: int = 8,
        store_dir: Optional[str] = None,
        snapshot_interval_ms: float = 1000.0,
        park_ttl_s: float = 900.0,
        token_ttl_s: Optional[float] = 3600.0,
        snapshot_keep: int = 2,
        device_claims: Optional[dict] = None,
        claims_dir: Optional[str] = None,
        event_dir: Optional[str] = None,
        metrics_port: Optional[int] = None,
    ):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if not hasattr(socket, "SO_REUSEPORT"):
            raise RuntimeError(
                "WorkerFront needs SO_REUSEPORT (Linux/BSD); this platform "
                "has no kernel-level listener load balancing"
            )
        self.factory = factory
        self.n_workers = n_workers
        self.host = host
        self.port = port
        self.env = dict(env or {})
        self.heartbeat_s = heartbeat_ms / 1e3
        self.respawn = respawn
        self.max_respawns = max_respawns
        # durable sessions: every worker snapshots into its own shard of
        # one shared store; None keeps the lose-on-crash contract
        self.store_dir = None if store_dir is None else str(store_dir)
        self._durability_cfg = None
        if self.store_dir is not None:
            self._durability_cfg = {
                "directory": self.store_dir,
                "snapshot_interval_ms": float(snapshot_interval_ms),
                "park_ttl_s": float(park_ttl_s),
                "token_ttl_s": token_ttl_s,
                "keep": int(snapshot_keep),
            }
        # device-claim registry: {worker index: [device, ...]}, validated
        # for overlap HERE (fail before any worker boots) and enforced
        # again by each worker against the on-disk registry at boot
        self.device_claims = None
        self._claims_dir = None
        if device_claims is not None:
            claims = {int(i): list(devs) for i, devs in device_claims.items()}
            unknown = sorted(i for i in claims if not 0 <= i < n_workers)
            if unknown:
                raise ValueError(
                    f"device_claims for nonexistent worker index(es) "
                    f"{unknown} (n_workers={n_workers})"
                )
            validate_disjoint(
                {f"worker-{i}": devs for i, devs in claims.items()}
            )
            self._claims_dir = claims_dir or self.store_dir
            if self._claims_dir is None:
                raise ValueError(
                    "device_claims needs a registry directory: pass "
                    "claims_dir= (or store_dir=, which it defaults to)"
                )
            self.device_claims = claims
        # observability plane: a per-worker JSONL event log plus one
        # /metrics endpoint per process — supervisor (front aggregate) on
        # the base port, worker i on base+1+i (all ephemeral when base=0)
        self.event_dir = None if event_dir is None else str(event_dir)
        self.metrics_port = metrics_port if metrics_port is None else int(metrics_port)
        self._obs_cfg = None
        if self.event_dir is not None or self.metrics_port is not None:
            self._obs_cfg = {"event_dir": self.event_dir,
                             "metrics_port": self.metrics_port}
        self.metrics: Optional[MetricsServer] = None
        self._events = EventLog(None)
        self.restarts = 0
        self.sessions_lost = 0
        self.sessions_migrated = 0
        # autoscaling state: target_workers is the controller's current
        # setpoint (starts at the configured count); the control plane
        # (repro_torch.control.ControlLoop) attaches itself here when enabled
        self.target_workers = n_workers
        self.scale_ups = 0
        self.scale_downs = 0
        self.control = None
        self._last_recalibrate: Optional[dict] = None
        self._last_batching: Optional[dict] = None
        self._ctx = mp.get_context("spawn")  # never fork a CUDA parent
        self._workers: dict[int, _Worker] = {}
        self._reserve: Optional[socket.socket] = None
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._monitor: Optional[threading.Thread] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._shutting_down = False
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def start(self, ready_timeout: float = 180.0) -> tuple:
        """Reserve the port, spawn the workers, wait until every worker's
        server is bound; returns ``(host, port)``."""
        if self._started:
            raise RuntimeError("front already started")
        self._reserve = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._reserve.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._reserve.bind((self.host, self.port))
        self.host, self.port = self._reserve.getsockname()[:2]
        self._started = True
        if self.event_dir is not None:
            self._events = EventLog(
                os.path.join(self.event_dir, "supervisor.jsonl"))
            self._events.emit("boot", workers=self.n_workers,
                              host=self.host, port=self.port)
        # the executor services worker-initiated fan-outs (aggregate /
        # recalibrate_all); it must not run them on a pipe-reader thread
        # or the fan-out would deadlock waiting on its own reader
        self._executor = ThreadPoolExecutor(
            max_workers=max(2, self.n_workers), thread_name_prefix="front-ctl"
        )
        for i in range(self.n_workers):
            self._spawn(i)
        deadline = time.monotonic() + ready_timeout
        for w in list(self._workers.values()):
            while not w.ready.wait(0.2):
                if not w.proc.is_alive():  # died before binding (bad
                    w.proc.join(1.0)       # factory, import error, ...)
                    self._abort_start(
                        f"worker {w.index} exited with code "
                        f"{w.proc.exitcode} before becoming ready"
                        f"{': ' + w.error if w.error else ''}")
                if time.monotonic() > deadline:
                    self._abort_start(
                        f"worker {w.index} not ready after "
                        f"{ready_timeout:.0f}s "
                        f"({w.error or 'no error reported'})")
            if w.error is not None:
                self._abort_start(f"worker {w.index} failed to start: {w.error}")
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="front-monitor", daemon=True
        )
        self._monitor.start()
        if self.metrics_port is not None:
            try:
                self.metrics = MetricsServer(
                    self.stats, host=self.host, port=self.metrics_port,
                    labels={"scope": "front"},
                ).start()
            except OSError as exc:
                logger.warning("front /metrics bind on port %d failed (%s); "
                               "per-worker endpoints are unaffected",
                               self.metrics_port, exc)
        return self.host, self.port

    def _abort_start(self, reason: str) -> None:
        self._shutting_down = True
        for w in self._workers.values():
            if w.proc.is_alive():
                w.proc.terminate()
        self._close_reserve()
        self._events.emit("abort", reason=reason)
        self._events.close()
        raise RuntimeError(reason)

    def _spawn(self, index: int) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        claim = None
        if self.device_claims is not None and index in self.device_claims:
            claim = {"dir": self._claims_dir,
                     "devices": self.device_claims[index]}
        proc = self._ctx.Process(
            target=_worker_main,
            args=(index, child_conn, self.host, self.port, self.factory,
                  self.heartbeat_s, self._durability_cfg, claim,
                  self._obs_cfg),
            name=f"gateway-worker-{index}",
            daemon=True,
        )
        worker = _Worker(index, proc, parent_conn)
        # written from start() AND the monitor thread (respawn) while
        # stats()/broadcasts iterate from other threads — keep the
        # insert under the class lock
        with self._lock:
            self._workers[index] = worker
        # env overrides (CUDA_VISIBLE_DEVICES et al.) must be in the
        # child's boot environment BEFORE any of its imports run — spawn inherits the
        # parent environment at exec time, so apply/restore around start()
        saved = {k: os.environ.get(k) for k in self.env}
        try:
            os.environ.update(self.env)
            proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        child_conn.close()
        worker.pid = proc.pid
        threading.Thread(
            target=self._reader_loop, args=(worker,),
            name=f"front-reader-{index}", daemon=True,
        ).start()

    def _close_reserve(self) -> None:
        if self._reserve is not None:
            try:
                self._reserve.close()
            finally:
                self._reserve = None

    # -- supervisor threads ------------------------------------------------

    def _reader_loop(self, worker: _Worker) -> None:
        """Drain one worker's pipe: events update supervisor state,
        replies resolve pending requests, worker-initiated requests go to
        the executor."""
        while True:
            try:
                msg = worker.conn.recv()
            except (EOFError, OSError):
                return
            event = msg.get("event")
            if event == "ready":
                worker.pid = msg.get("pid", worker.pid)
                worker.metrics_port = msg.get("metrics_port")
                worker.ready.set()
            elif event == "heartbeat":
                worker.last_active = int(msg.get("active", 0))
                worker.last_queue_depth = int(msg.get("queue_depth", 0))
            elif event == "drained":
                worker.drain_summary = msg.get("summary")
            elif event == "error":
                worker.error = msg.get("message")
                worker.ready.set()  # unblock start() with the reason
            elif "wid" in msg:
                if self._executor is not None:
                    self._executor.submit(self._serve_worker_request,
                                          worker, msg)
            elif "id" in msg:
                pending = worker.pending.pop(msg["id"], None)
                if pending is not None:
                    pending[1] = msg
                    pending[0].set()

    def _serve_worker_request(self, worker: _Worker, msg: dict) -> None:
        """A worker asked for a front-wide operation; run the fan-out and
        reply over its pipe."""
        op, kw = msg.get("op"), msg.get("kw", {})
        try:
            if op == "aggregate":
                result = self.stats()
            elif op == "recalibrate_all":
                result = self.recalibrate(**kw)
            else:
                raise ValueError(f"unknown front op {op!r}")
            worker.send({"wid": msg["wid"], "result": result})
        except Exception as exc:
            try:
                worker.send({"wid": msg["wid"],
                             "error": f"{type(exc).__name__}: {exc}"})
            except Exception:
                logger.debug("worker %d: error reply failed (pipe gone?)",
                             worker.index, exc_info=True)

    def _monitor_loop(self) -> None:
        """Watch worker sentinels; respawn crashed workers (same index,
        same port) with session-loss accounting."""
        while not self._shutting_down:
            with self._lock:  # scale_down() removes entries concurrently
                workers = list(self._workers.values())
            sentinels = {w.proc.sentinel: w for w in workers
                         if w.proc.is_alive()}
            if not sentinels:
                time.sleep(0.05)
                continue
            dead = mp.connection.wait(list(sentinels), timeout=0.25)
            for s in dead:
                w = sentinels[s]
                if self._shutting_down or w.scaling_down:
                    continue  # shutdown() / scale_down() own this exit and
                    # reap it: a second reaper here would race them (_exited)
                w.proc.join(1.0)
                w.exitcode = w.proc.exitcode
                if w.drain_summary is not None:
                    continue  # a drained exit is handled by shutdown()
                # with a snapshot store the victim's residents are not
                # lost — any worker can resume them from its shard — so
                # only count them against a front running without one
                durable = self._durability_cfg is not None
                with self._lock:
                    self.restarts += 1
                    if not durable:
                        self.sessions_lost += w.last_active
                logger.warning(
                    "worker %d (pid %s) died with exitcode %s; %d resident "
                    "session(s) %s; respawning",
                    w.index, w.pid, w.exitcode, w.last_active,
                    "resumable from snapshots" if durable else "lost",
                )
                self._events.emit(
                    "respawn", worker=w.index, pid=w.pid,
                    exitcode=w.exitcode, sessions_resident=w.last_active,
                    durable=durable,
                    respawned=(self.respawn
                               and self.restarts <= self.max_respawns),
                )
                if not self.respawn or self.restarts > self.max_respawns:
                    logger.error("worker %d not respawned (respawn=%s, "
                                 "restarts=%d)", w.index, self.respawn,
                                 self.restarts)
                    continue
                self._spawn(w.index)
                # do NOT block here waiting for readiness: a slow boot
                # must not leave the other workers' crashes unwatched —
                # a side thread waits and replays the live recalibration
                # (a respawn rebuilds from the factory, which would
                # otherwise quietly revert one acceptor to factory state)
                threading.Thread(
                    target=self._finish_respawn,
                    args=(self._workers[w.index],),
                    name=f"front-respawn-{w.index}", daemon=True,
                ).start()

    def _finish_respawn(self, worker: _Worker) -> None:
        """Off the monitor thread: wait (bounded) for the respawned
        worker and bring it back in line with the front's live state."""
        if not worker.ready.wait(180.0):
            logger.error("respawned worker %d never became ready",
                         worker.index)
            return
        if self._shutting_down:
            return
        if self._last_recalibrate is not None:
            try:
                self._request(worker, "recalibrate", **self._last_recalibrate)
                logger.info("worker %d: replayed live recalibration after "
                            "respawn", worker.index)
            except Exception:
                logger.exception("worker %d: recalibration replay failed — "
                                 "this acceptor serves factory thresholds",
                                 worker.index)
        if self._last_batching is not None:
            # same reasoning as recalibrate: a respawn rebuilds from the
            # factory's static knobs, which would quietly revert one
            # acceptor to the pre-adaptation operating point
            try:
                self._request(worker, "control", **self._last_batching)
            except Exception:
                logger.exception("worker %d: batching-knob replay failed — "
                                 "this acceptor serves factory knobs",
                                 worker.index)

    # -- control fan-out ---------------------------------------------------

    def _request(self, worker: _Worker, op: str, timeout: float = 15.0,
                 **kw) -> dict:
        rid = next(self._rid)
        pending = [threading.Event(), None]
        worker.pending[rid] = pending
        try:
            worker.send({"id": rid, "op": op, "kw": kw})
            if not pending[0].wait(timeout):
                raise TimeoutError(f"worker {worker.index}: {op} timed out "
                                   f"after {timeout:.0f}s")
        finally:
            worker.pending.pop(rid, None)
        reply = pending[1]
        if "error" in reply:
            raise RuntimeError(f"worker {worker.index}: {reply['error']}")
        return reply["result"]

    def _fan_out(self, op: str, **kw) -> tuple[list, int]:
        """Run ``op`` on every live worker CONCURRENTLY (wall time is the
        slowest worker, not the sum — the worker-side aggregate await is
        budgeted against one worker's timeout, see ``supervisor_request``);
        returns ``(answered, attempted)`` where ``answered`` is the
        ``(worker, result)`` pairs and ``attempted`` counts the live
        workers asked — callers that need all-or-nothing semantics
        (recalibrate) compare the two.  A worker mid-crash is skipped —
        the monitor is already respawning it."""
        with self._lock:  # snapshot: scale_down() mutates the map; its
            # scaling_down flag excludes the departing worker the moment
            # the decision lands, so no fan-out targets a draining worker
            targets = [w for w in self._workers.values()
                       if w.proc.is_alive() and w.ready.is_set()
                       and not w.scaling_down]
        slots: list = [None] * len(targets)

        def _one(i: int, w: _Worker) -> None:
            try:
                slots[i] = (w, self._request(w, op, **kw))
            except Exception:
                logger.exception("worker %d: %s fan-out failed", w.index, op)

        threads = [threading.Thread(target=_one, args=(i, w), daemon=True)
                   for i, w in enumerate(targets)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return [s for s in slots if s is not None], len(targets)

    @property
    def alive_workers(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers.values() if w.proc.is_alive())

    def worker_pids(self) -> list[int]:
        with self._lock:
            return [w.pid for w in self._workers.values() if w.proc.is_alive()]

    def stats(self) -> dict:
        """Aggregated front telemetry: per-worker ``gateway.stats()``
        snapshots (over the control pipes) plus summed pool/queue
        counters and capacities.  ``latency_ms`` percentiles are EXACT
        front-wide values: every worker ships its fixed-boundary latency
        histograms and the front sums bucket counts, which reproduces the
        histogram of the union of all workers' samples bit for bit (no
        worst-worker approximation); rate keys sum."""
        results, _ = self._fan_out("stats")
        per_worker = []
        for w, s in results:
            w.last_active = int(s.get("active_streams", w.last_active))
            per_worker.append({"index": w.index, "pid": w.pid,
                               "metrics_port": w.metrics_port, **s})
        counters: dict[str, float] = {}
        for _, s in results:
            for k, v in s.get("counters", {}).items():
                counters[k] = counters.get(k, 0.0) + float(v)
        merged: dict[str, Histogram] = {}
        for _, s in results:
            for name, data in (s.get("histograms") or {}).items():
                merged.setdefault(name, Histogram()).merge_from(
                    Histogram.from_dict(data))
        agg = {
            "workers": {
                "count": len(results),
                "configured": self.n_workers,
                "target": self.target_workers,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "restarts": self.restarts,
                "sessions_lost": self.sessions_lost,
                "sessions_migrated": self.sessions_migrated,
                "durable": self.store_dir is not None,
            },
            "per_worker": per_worker,
            "counters": counters,
        }
        for key in ("capacity", "active_streams", "queue_depth"):
            agg[key] = int(sum(int(s.get(key, 0)) for _, s in results))
        # lifetime averages AND windowed rates both sum across workers
        # (the control plane reads the windowed keys)
        for key in ("requests_per_s", "stream_steps_per_s",
                    "arrival_rps_window", "completed_rps_window"):
            agg[key] = sum(float(s.get(key, 0.0)) for _, s in results)
        filled = counters.get("batch.filled", 0.0)
        slots = counters.get("batch.slots", 0.0)
        agg["batch_fill_ratio"] = filled / slots if slots else 0.0
        agg["histograms"] = {k: h.to_dict() for k, h in merged.items()}
        req = merged.get(REQUEST_HIST, Histogram())
        agg["latency_ms"] = {
            "count": req.count,
            "p50": req.percentile(50),
            "p95": req.percentile(95),
            "p99": req.percentile(99),
            "sum_ms": req.sum,
            "buckets": {str(i): n for i, n in sorted(req.counts.items())},
        }
        if results:
            first = results[0][1]
            for key in ("schedule", "threshold", "features", "max_batch",
                        "max_seq_len"):
                agg[key] = first.get(key)
        if self.control is not None:
            agg["control"] = self.control.describe()
        return agg

    def recalibrate(self, *, threshold=_UNSET, params=None, **kw) -> dict:
        """Fan a live recalibration out to EVERY worker (each worker owns
        a private engine/service, so a threshold swap must hit all of
        them or acceptors would disagree about alerts).  All-or-error: a
        PARTIAL application raises rather than reporting success, because
        divergent thresholds across acceptors are worse than a failed
        swap (retry until it answers for every worker).  The last fully
        applied recalibration is replayed onto respawned workers so a
        crash cannot quietly revert one acceptor to factory state.

        ``params`` swaps the MODEL on every worker: the tree (tensors or
        numpy arrays) is copied to host numpy here — a tensor would cross
        the pipe as a shared-memory or CUDA IPC handle — shipped over each
        control pipe, and landed on each worker's own device worker-side.  Resident sessions keep their
        slots and carried state, exactly like a threshold swap — and like
        a threshold swap, the params replay onto respawned workers."""
        if threshold is not _UNSET:
            kw["threshold"] = threshold
        if params is not None:
            kw["params"] = params_to_numpy(params)
        results, attempted = self._fan_out("recalibrate", **kw)
        if not results:
            raise RuntimeError("no live workers to recalibrate")
        if len(results) < attempted:
            raise RuntimeError(
                f"recalibrate reached only {len(results)}/{attempted} "
                f"workers — acceptors now disagree; retry to converge"
            )
        self._last_recalibrate = dict(kw)
        # close the respawn race: a worker that became ready DURING the
        # fan-out was not a target and _finish_respawn may have read the
        # previous _last_recalibrate — replay onto any ready worker the
        # fan-out missed before reporting success
        answered = {id(w) for w, _ in results}
        for w in list(self._workers.values()):
            if (w.proc.is_alive() and w.ready.is_set()
                    and id(w) not in answered):
                try:
                    self._request(w, "recalibrate", **kw)
                except Exception:
                    logger.exception("worker %d: post-fan-out recalibrate "
                                     "replay failed", w.index)
        out = dict(results[0][1])
        out["workers"] = len(results)
        return out

    def set_batching(self, max_batch: Optional[int] = None,
                     max_wait_ms: Optional[float] = None) -> dict:
        """Fan adjusted batching knobs out to every live worker (the
        control plane's actuation path; each worker clamps ``max_batch``
        to its captured lane count).  Best-effort by design — a
        worker mid-respawn picks the knobs up from the replay in
        ``_finish_respawn`` — and the last applied knobs are remembered
        for exactly that replay.  Returns the first worker's applied
        values plus the reach count."""
        kw = {}
        if max_batch is not None:
            kw["max_batch"] = int(max_batch)
        if max_wait_ms is not None:
            kw["max_wait_ms"] = float(max_wait_ms)
        if not kw:
            raise ValueError("nothing to set: pass max_batch or max_wait_ms")
        results, attempted = self._fan_out("control", **kw)
        with self._lock:
            merged = dict(self._last_batching or {})
            merged.update(kw)
            self._last_batching = merged
        out = dict(results[0][1]) if results else dict(kw)
        out["workers"] = len(results)
        out["attempted"] = attempted
        return out

    # -- autoscaling -------------------------------------------------------

    def scale_up(self, ready_timeout: float = 180.0) -> dict:
        """Add one worker (lowest unused index) on the same shared port.

        Reuses the respawn machinery: the new worker builds from the
        factory, then the live recalibration and batching knobs are
        replayed onto it so it serves the front's CURRENT operating
        point, not factory state.  Blocks until the worker is ready (it
        only starts taking kernel-balanced connections once it listens).
        """
        if not self._started:
            raise RuntimeError("front not started")
        with self._lock:
            if self._shutting_down:
                raise RuntimeError("front is shutting down")
            index = 0
            while index in self._workers:
                index += 1
            self.target_workers = len(self._workers) + 1
            self.scale_ups += 1
        self._spawn(index)
        worker = self._workers[index]
        if not worker.ready.wait(ready_timeout):
            raise TimeoutError(
                f"scale-up worker {index} not ready after {ready_timeout:.0f}s"
                f" ({worker.error or 'no error reported'})"
            )
        if worker.error is not None:
            raise RuntimeError(f"scale-up worker {index} failed: {worker.error}")
        for op, kw in (("recalibrate", self._last_recalibrate),
                       ("control", self._last_batching)):
            if kw is not None:
                try:
                    self._request(worker, op, **kw)
                except Exception:
                    logger.exception("worker %d: %s replay after scale-up "
                                     "failed", index, op)
        self._events.emit("scale_up", worker=index, pid=worker.pid,
                          workers=self.alive_workers)
        return {"index": index, "pid": worker.pid,
                "workers": self.alive_workers}

    def scale_down(self, timeout: float = 60.0) -> dict:
        """Remove one worker (highest live index) via the zero-drop drain.

        This is the coordinated drain applied to a single worker,
        never a kill: the victim stops being a fan-out/stats target the
        moment it is chosen (``scaling_down``, set under the lock —
        capacity figures update atomically with the decision, so no
        admission-facing snapshot ever counts a departing worker), gets
        SIGTERM, answers every pending ticket, hands its resident
        sessions off to the snapshot store when durability is on, and
        reports the same summary fields a full-front shutdown reports:
        ``dropped_tickets`` / ``sessions_migrated`` / ``sessions_lost``.
        """
        if not self._started:
            raise RuntimeError("front not started")
        with self._lock:
            live = [w for w in self._workers.values()
                    if w.proc.is_alive() and w.ready.is_set()
                    and not w.scaling_down]
            if len(live) <= 1:
                raise RuntimeError(
                    f"cannot scale below one worker ({len(live)} live)"
                )
            victim = max(live, key=lambda w: w.index)
            victim.scaling_down = True
            self.target_workers = len(live) - 1
            self.scale_downs += 1
        try:
            os.kill(victim.pid, signal.SIGTERM)
        except (ProcessLookupError, OSError):
            pass
        if not _exited(victim.proc, timeout):
            logger.error("worker %d did not drain in %.0fs during "
                         "scale-down; terminating", victim.index, timeout)
            victim.proc.terminate()
            _exited(victim.proc, 5.0)
        victim.exitcode = victim.proc.exitcode
        if victim.exitcode == 0 and victim.drain_summary is None:
            # same settle as shutdown(): the reader thread may not have
            # consumed the buffered "drained" event yet
            settle = time.monotonic() + 2.0
            while victim.drain_summary is None and time.monotonic() < settle:
                time.sleep(0.01)
        summary = victim.drain_summary
        clean = victim.exitcode == 0 and summary is not None
        if clean:
            dropped = int(summary.get("pending_after_drain", 0))
            migrated = int(summary.get("sessions_migrated", 0))
            lost = int(summary.get("sessions_lost", 0))
        else:
            dropped = victim.last_queue_depth
            migrated = 0
            lost = victim.last_active
        with self._lock:
            self._workers.pop(victim.index, None)
            self.sessions_migrated += migrated
            self.sessions_lost += lost
        self._events.emit("scale_down", worker=victim.index,
                          pid=victim.pid, clean=clean,
                          dropped_tickets=dropped,
                          sessions_migrated=migrated, sessions_lost=lost,
                          workers=self.alive_workers)
        return {
            "index": victim.index, "pid": victim.pid,
            "exitcode": victim.exitcode, "clean": clean,
            "dropped_tickets": dropped,
            "sessions_migrated": migrated,
            "sessions_lost": lost,
            "workers": self.alive_workers,
        }

    # -- shutdown ----------------------------------------------------------

    def shutdown(self, timeout: float = 120.0) -> dict:
        """Coordinated drain: SIGTERM every worker, wait for each to
        answer all pending tickets and exit, aggregate the drain
        summaries.  Returns the front summary: ``dropped_tickets`` is the
        sum of tickets left unanswered (0 on a clean drain; a
        force-terminated worker contributes its last-heartbeat queue
        depth), while ``counters`` cover only CLEANLY drained workers — a
        terminated worker's lifetime counters die with it, so on a
        partial drain the totals undercount served traffic (the per-entry
        ``exits`` list says which workers are covered)."""
        if not self._started:
            raise RuntimeError("front not started")
        self._shutting_down = True
        if self.control is not None:
            try:  # stop the control thread first: no scale decisions
                self.control.stop()  # may race a drain in progress
            except Exception:
                logger.exception("control loop stop failed during shutdown")
            self.control = None
        deadline = time.monotonic() + timeout
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if not w.proc.is_alive():
                continue
            # a worker still booting (e.g. just respawned) has no signal
            # handling installed yet — give it a bounded chance to come
            # up so its drain is clean rather than a raw SIGTERM death
            if not w.ready.is_set():
                w.ready.wait(min(60.0, max(0.1, deadline - time.monotonic())))
            try:
                os.kill(w.pid, signal.SIGTERM)
            except (ProcessLookupError, OSError):
                # already exited — the goal state; join below records it
                logger.debug("worker %d: SIGTERM at shutdown found it gone",
                             w.index)
        exits = []
        dropped = 0
        counters: dict[str, float] = {}
        clean = 0
        migrated = 0
        drain_lost = 0
        for w in workers:
            if not _exited(w.proc, max(0.1, deadline - time.monotonic())):
                # a worker stuck mid-drain: last resort
                logger.error("worker %d did not drain in time; terminating",
                             w.index)
                w.proc.terminate()
                _exited(w.proc, 5.0)
            w.exitcode = w.proc.exitcode
            if w.exitcode == 0 and w.drain_summary is None:
                # the process is gone but its reader thread may not have
                # consumed the buffered "drained" event yet — give it a
                # beat before declaring the exit unclean
                settle = time.monotonic() + 2.0
                while w.drain_summary is None and time.monotonic() < settle:
                    time.sleep(0.01)
            summary = w.drain_summary
            is_clean = w.exitcode == 0 and summary is not None
            if is_clean:
                clean += 1
                dropped += int(summary.get("pending_after_drain", 0))
                migrated += int(summary.get("sessions_migrated", 0))
                drain_lost += int(summary.get("sessions_lost", 0))
                for k, v in summary.get("counters", {}).items():
                    counters[k] = counters.get(k, 0.0) + float(v)
            else:
                # a worker that died or was force-terminated mid-drain
                # never answered its parked tickets; its last-heartbeat
                # queue depth is the best accounting of what it dropped
                dropped += w.last_queue_depth
                drain_lost += w.last_active
            exits.append({
                "index": w.index, "pid": w.pid, "exitcode": w.exitcode,
                "clean": is_clean,
                "pending_after_drain": (summary or {}).get(
                    "pending_after_drain"),
                "active_before_drain": (summary or {}).get(
                    "active_before_drain"),
            })
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        if self.metrics is not None:
            try:
                self.metrics.stop()
            finally:
                self.metrics = None
        self._close_reserve()
        self.sessions_migrated += migrated
        self._events.emit("drain", clean_exits=clean,
                          dropped_tickets=dropped,
                          sessions_migrated=migrated,
                          sessions_lost=self.sessions_lost + drain_lost)
        self._events.close()
        return {
            # the workers present AT shutdown (autoscaling may have moved
            # the fleet away from the configured n_workers)
            "workers": len(workers),
            "clean_exits": clean,
            "dropped_tickets": dropped,
            "restarts": self.restarts,
            # migration accounting: with durability a clean drain reports
            # sessions_migrated == residents and adds 0 to sessions_lost;
            # without it, drain-dropped residents count as lost (they
            # were, exactly as before — now it is visible)
            "sessions_migrated": migrated,
            "sessions_lost": self.sessions_lost + drain_lost,
            "counters": counters,
            "exits": exits,
        }

    def run_until_signal(
        self, on_ready: Optional[Callable[["WorkerFront"], None]] = None
    ) -> dict:
        """start() -> wait for SIGINT/SIGTERM on the supervisor ->
        coordinated drain; returns the shutdown summary.  The launcher's
        serve loop for ``--workers N``.

        Handlers are installed BEFORE start() and stay installed through
        the drain: a SIGTERM while workers are still booting (the torch
        import, the kernel load and the captures take seconds) must queue a clean shutdown, and a second
        SIGTERM during the drain must be a no-op — not a
        default-disposition kill that drops every pending ticket."""
        stop = threading.Event()
        previous = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            previous[sig] = signal.signal(sig, lambda *_: stop.set())
        try:
            self.start()
            if on_ready is not None:
                on_ready(self)
            stop.wait()
            return self.shutdown()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def __repr__(self) -> str:
        state = "started" if self._started else "new"
        return (f"WorkerFront(workers={self.n_workers}, alive="
                f"{self.alive_workers}, {self.host}:{self.port}, {state}, "
                f"restarts={self.restarts})")


def default_gateway_factory(
    arch: str = "lstm-ae-f32-d2",
    schedule: str = "wavefront",
    *,
    reduced: bool = False,
    train_steps: int = 0,
    train_seq_len: int = 64,
    capacity: int = 32,
    max_batch: int = 16,
    max_wait_ms: float = 5.0,
    max_queue: int = 1024,
    mesh: int = 1,
    warm_seq_len: int = 0,
    priority_classes: int = 1,
    tenant_rate: Optional[float] = None,
    tenant_burst: Optional[float] = None,
    device=None,
) -> "object":
    """Picklable per-worker gateway builder (the launcher's ``--workers``,
    the smoke, tests).

    Runs IN the worker process: builds an :class:`AnomalyService` on
    ``schedule`` on ``device`` (None: the current CUDA device, which a
    device claim sets; it raises without a GPU — pass ``"cpu"`` for the
    CPU), optionally fits + calibrates it on that device — every worker
    re-fits from the same seed, so all workers serve the same params
    without shipping arrays across processes — and opens a gateway.
    ``mesh > 1`` lays the engine out on ``Placement.data(mesh)``: over the
    first ``mesh`` CUDA devices of the worker's device claim (fewer raise),
    else over the first ``mesh`` visible GPUs, or ``mesh`` emulated CPU
    devices on the CPU.  ``warm_seq_len > 0`` runs one full flush of
    that bucket before the worker reports ready, which captures its graph,
    so kernel connection balancing never lands traffic on a cold worker.
    """
    from repro_torch.config import get_config, reduced_config
    from repro_torch.data import TimeseriesConfig
    from repro_torch.engine import AnomalyService, EngineConfig, Placement

    cfg = reduced_config(arch) if reduced else get_config(arch)
    sched = schedule
    if mesh > 1:
        claimed = [d for d in process_claim() if d.startswith("cuda:")]
        if claimed and len(claimed) < mesh:
            raise ValueError(f"mesh={mesh} needs {mesh} CUDA devices in the worker's "
                             f"device claim, which names {claimed}")
        sched = EngineConfig(schedule=schedule,
                             placement=Placement.data(mesh, devices=tuple(claimed[:mesh])))
    svc = AnomalyService(cfg, schedule=sched, device=device)
    if train_steps:
        fit_cfg = TimeseriesConfig(features=svc.features,
                                   seq_len=train_seq_len, batch=64)
        svc.fit(fit_cfg, train_steps)
        svc.calibrate(fit_cfg)
    gw = svc.open_gateway(capacity=capacity, max_batch=max_batch,
                          max_wait_ms=max_wait_ms, max_queue=max_queue)
    if priority_classes > 1 or tenant_rate is not None:
        # worker-side admission: shedding must happen where requests
        # arrive.  Batching/autoscaling run supervisor-side (ControlLoop)
        # so no SLO here — this gateway's control is admission-only.
        from repro_torch.control import ControlConfig, enable_control

        enable_control(gw, ControlConfig(
            priority_classes=priority_classes,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst,
        ))
    if warm_seq_len > 0:
        warm = np.zeros((max_batch, warm_seq_len, svc.features), np.float32)
        gw.score(list(warm))
        gw.telemetry.reset()  # warm-up is not traffic: served counters,
        #                       fill ratios and drain summaries start at 0
    return gw


__all__ = ["WorkerFront", "default_gateway_factory"]
