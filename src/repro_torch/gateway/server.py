"""Async JSON-lines and bp1 transport in front of :class:`AnomalyGateway`.

Counterpart of ``repro/gateway/server.py``: the same protocols, ops,
errors and drain semantics, so either package's client talks to either
package's server.  The paper's accelerator wins because its datapath is
always fed; the in-process gateway reproduces that only while some caller
keeps pumping the micro-batch queue.  :class:`GatewayServer` closes that
gap: an asyncio socket server whose *background pump task* flushes
age-triggered micro-batches on its own clock, so one-shot latency is
bounded by ``max_wait_ms`` — not by when the next request happens to
arrive.

Wire protocol — one JSON object per line (UTF-8, ``\\n``-terminated) in
each direction.  Every request may carry an ``id``, echoed verbatim in
its response; responses to ``score`` arrive when the micro-batcher
flushes, i.e. possibly *after* responses to later requests — match on
``id``, not on order.

======================  ==================================================
request                 response
======================  ==================================================
``{"op": "step",        ``{"ok": true, "op": "step",
"x": [f_0 .. f_F-1]}``  "running_error": .., "alert": ..?}`` — advances
                        this connection's pool session one timestep
                        (admitted on first step; the connection IS the
                        stream).
``{"op": "close"}``     ``{"ok": true, "op": "close", "final": ..,
                        "alert": ..?}`` — evicts the session (final
                        running error); a later ``step`` starts a fresh
                        one.  Dropping the connection evicts too, the
                        final score is just unreported.
``{"op": "score",       ``{"ok": true, "op": "score", "score": ..,
"series": [[..] ..]}``  "alert": ..?}`` — one-shot (T, F) window through
                        the micro-batcher; the response is written when
                        the ticket's future completes (flush by size,
                        by the background pump, or at drain).  Optional
                        ``priority`` (int, 0 = highest class) and
                        ``tenant`` (string) fields feed the admission
                        controller when a control plane is attached;
                        both are ignored otherwise (backward compatible
                        like ``trace``) and omitting them is exactly
                        the pre-control wire protocol.
``{"op":                ``{"ok": true, "op": "recalibrate",
"recalibrate",          "threshold": .., "params_swapped": false}`` —
"threshold": ..}``      live threshold swap, resident sessions keep
                        serving (param swaps are in-process only).
``{"op": "stats"}``     ``{"ok": true, "op": "stats", "stats": {..}}`` —
                        under a sharded placement the snapshot includes a
                        ``placement`` section (mesh layout, per-device
                        slot occupancy) plus ``pool.device_active`` /
                        ``queue.device_fill`` gauges, so mesh imbalance
                        is observable over the wire.  Behind a
                        multi-worker front (:mod:`repro_torch.gateway.workers`)
                        the snapshot is AGGREGATED over all workers:
                        counters/capacities sum, and a ``workers``
                        section carries per-worker detail plus
                        restart/session-loss accounting.
``{"op": "ping"}``      ``{"ok": true, "op": "ping"}``
``{"op": "resume",      ``{"ok": true, "op": "resume", "seq": ..,
"token": ..}``          "running_error": .., "token": ..}`` — revive a
                        durable session from its resumption token onto
                        THIS connection (any worker of a front); the
                        client then replays its buffered steps with
                        ``seq`` greater than the returned position.
``{"op": "snapshot"}``  ``{"ok": true, "op": "snapshot",
                        "sessions": .., "bytes": ..}`` — force one
                        synchronous durability snapshot (control op for
                        tests/ops; the background pump snapshots on its
                        own cadence).
======================  ==================================================

With durability enabled (``gateway.durability`` attached via
:func:`repro_torch.gateway.durability.enable_durability`) every ``step``
response additionally carries ``seq`` (the session's timestep count) and
``token`` (a fresh signed resumption token); abrupt connection drops
PARK the session (resumable) instead of discarding it, and ``drain()``
takes a final handoff snapshot so rolling restarts lose zero sessions.
``resume``/``snapshot`` against a server without durability fail with
``ValueError``; token rejections answer with the token error class name
(``TamperedTokenError`` / ``ExpiredTokenError`` / ``UnknownSessionError``
/ ``SessionActiveError``) in the ``error`` field.

Failures answer ``{"ok": false, "op": .., "error": "<ExceptionName>",
"message": ..}`` on the same ``id`` — ``GatewayOverloadedError`` /
``PoolFullError`` for backpressure, ``ValueError`` for malformed or
oversized windows, and whatever the engine raised for tickets failed
mid-flush (future-style error completion, the queue keeps serving).

Binary transport (bp1) — the JSON-lines protocol above stays the
negotiated fallback, but the hot path is the length-prefixed binary
frame format of :mod:`repro_torch.gateway.wire`.  A client that opens the
connection with the 4-byte ``bp1`` preamble switches the connection to
frame mode: the server answers a ``HELLO`` response frame and from then
on reads fixed 20-byte headers + raw payloads (``readexactly``, no line
scanning).  ``SCORE``/``STEP`` frames carry float32 payloads that land
in the micro-batcher via ``np.frombuffer`` views — no float lists — and
one ``SCORE`` frame may carry *n* same-shape windows (pipelined batched
submit; the response frame returns *n* float32 scores when the last
ticket completes).  Every other opcode is a generic meta frame whose
JSON ``meta`` is exactly the dict the JSON protocol would carry, so the
``_op_*`` handlers below serve both protocols unchanged (drain
semantics, resumption tokens, priority/tenant admission included).
Per-protocol traffic is visible in telemetry as ``wire.req_json`` /
``wire.req_bp1`` counters (and ``wire.conn_*`` per connection); the
``wire_ms`` stage histogram covers both dispatch paths.  Constructing
the server with ``enable_binary=False`` ignores the preamble and
behaves byte-for-byte like a JSON-lines-only server (that is also what
proves client fallback in tests).

Concurrency model: everything touching the gateway (handlers + pump +
drain) runs on ONE event loop, on one thread, preserving the gateway's
single-threaded contract.  On a GPU that thread runs every pool step,
flush, snapshot copy and recalibrate of the gateway, and so every capture
and replay of its CUDA graphs (``engine/capture.py``: a replay is not
re-entrant); it makes the gateway's device its current CUDA device before
its first CUDA call (:meth:`GatewayServer.start`), since a new thread
starts on device 0.  Device work blocks the loop for one step/flush at a
time, which is the micro-batching granularity anyway.  ``drain()`` is
the graceful shutdown: stop accepting, flush the queue so every pending
ticket answers, hand durable sessions off to disk, then close the
connections, whose handlers evict (or park) their sessions.
"""
from __future__ import annotations

import asyncio
import inspect
import json
import logging
import signal
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.gateway import AnomalyGateway, wire

logger = logging.getLogger(__name__)

#: What the server's readline loop sees when a binary client opens with
#: ``wire.PREAMBLE`` (readline keeps the ``\n``; dispatch strips it).
_PREAMBLE_LINE = wire.PREAMBLE.rstrip(b"\n")


def _error_payload(op: str, exc: BaseException) -> dict:
    return {
        "ok": False,
        "op": op,
        "error": type(exc).__name__,
        "message": str(exc),
    }


class GatewayServer:
    """Serve an :class:`AnomalyGateway` over asyncio JSON-lines sockets.

    >>> server = GatewayServer(svc.open_gateway(capacity=32), port=0)
    >>> host, port = server.start_in_thread()     # tests/benchmarks
    >>> # ... or await server.start() inside a running loop
    >>> server.stop_in_thread()                   # drain + shut down

    ``port=0`` binds an ephemeral port (read it back from ``server.port``
    after start).  The background pump runs every ``pump_interval_ms``
    (default: half the batcher's ``max_wait_ms``) so age-triggered
    flushes never wait on request arrival.
    """

    def __init__(
        self,
        gateway: AnomalyGateway,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        pump_interval_ms: Optional[float] = None,
        max_line_bytes: int = 16 << 20,
        stats_provider: Optional[Callable] = None,
        recalibrate_provider: Optional[Callable] = None,
        enable_binary: bool = True,
        reuse_port: bool = False,
    ):
        if not isinstance(gateway, AnomalyGateway):
            raise TypeError(f"expected AnomalyGateway, got {type(gateway)!r}")
        self.gateway = gateway
        self.host = host
        self.port = port
        # multi-worker mode (repro_torch.gateway.workers): several servers
        # bind the same port with SO_REUSEPORT and the kernel load-balances
        # connections; stats/recalibrate then answer for the whole front
        # via the providers (which may return an awaitable — the fan-out
        # crosses a control pipe) instead of this process's gateway alone
        self.reuse_port = reuse_port
        self.stats_provider = stats_provider
        self.recalibrate_provider = recalibrate_provider
        # generous line limit: a max_seq_len x F window as JSON text is
        # ~20 bytes/float; the gateway's own admission limits do the real
        # policing, this just keeps asyncio from resetting the connection
        self.max_line_bytes = max_line_bytes
        # enable_binary=False serves JSON lines only (the bp1 preamble is
        # then just an undecodable line) — used by tests to prove client
        # auto-negotiation falls back cleanly
        self.enable_binary = enable_binary
        if pump_interval_ms is None:
            pump_interval_ms = max(0.5, gateway.batcher.max_wait_ms / 2.0)
        self.pump_interval_s = pump_interval_ms / 1e3
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._handlers: set = set()
        self._writers: set = set()
        self._conn_seq = 0
        self._draining = False
        # thread-mode bookkeeping (start_in_thread)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> tuple:
        """Bind the socket and start the background pump; returns
        ``(host, port)`` actually bound.  Runs on the loop's thread, which
        takes the gateway's CUDA device as its current device here."""
        if self._server is not None:
            raise RuntimeError("server already started")
        device = self.gateway.engine.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        self._draining = False
        extra = {"reuse_port": True} if self.reuse_port else {}
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=self.max_line_bytes,
            **extra,
        )
        self.host, self.port = self._server.sockets[0].getsockname()[:2]
        self._pump_task = asyncio.get_running_loop().create_task(self._pump_loop())
        self.gateway.events.emit("serve_start", host=self.host, port=self.port)
        return self.host, self.port

    async def drain(self, timeout: float = 10.0) -> None:
        """Graceful shutdown: stop accepting connections, flush the
        micro-batch queue (every pending ticket completes — scored or
        failed — and its response is written), hand durable sessions off
        to disk, then close the connections and wait for their handlers,
        which evict (or park) the remaining sessions."""
        self._draining = True
        if self._server is not None:
            # close() stops the listener at once.  Server.wait_closed() is
            # never awaited: from Python 3.12.1 it waits until every open
            # connection has closed, and the connections close only below,
            # after the flush — awaiting it here would hold the pending
            # tickets until the clients gave up
            self._server.close()
            self._server = None
        if self._pump_task is not None:
            self._pump_task.cancel()
            await asyncio.gather(self._pump_task, return_exceptions=True)
            self._pump_task = None
        try:
            self.gateway.flush()  # completes pending tickets -> responses go out
        except Exception:
            logger.exception("drain: final flush failed")
        if self.gateway.durability is not None:
            # snapshot-handoff BEFORE sessions are evicted at connection
            # teardown: every resident durable stream lands on disk, so a
            # rolling restart migrates instead of losing them
            try:
                self.gateway.durability.handoff()
            except Exception:
                logger.exception("drain: durability handoff failed")
        for writer in list(self._writers):
            try:
                if writer.can_write_eof():
                    writer.write_eof()
                writer.close()
            except Exception:
                logger.debug("writer close failed during drain",
                             exc_info=True)
        if self._handlers:  # handlers evict their sessions on the way out
            await asyncio.wait(self._handlers, timeout=timeout)
        self.gateway.events.emit(
            "drain", active_streams=self.gateway.pool.active,
            queue_depth=self.gateway.batcher.queue_depth,
        )

    async def serve_forever(self) -> None:
        if self._server is None:
            raise RuntimeError("call start() first")
        await self._server.serve_forever()

    async def run_until_signal(
        self, on_ready: Optional[Callable[["GatewayServer"], None]] = None
    ) -> None:
        """start() -> wait for SIGINT/SIGTERM -> drain().  The launcher's
        serve loop; the tests assert clean shutdown by sending SIGTERM and
        checking the exit code."""
        await self.start()
        if on_ready is not None:
            on_ready(self)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # non-unix event loops
                signal.signal(sig, lambda *_: stop.set())
        await stop.wait()
        await self.drain()

    # -- thread mode (tests / benchmarks / notebooks) ----------------------

    def start_in_thread(self, ready_timeout: float = 30.0) -> tuple:
        """Run the server on a private event loop in a daemon thread;
        returns ``(host, port)``.  All gateway access happens on that
        loop's thread, preserving the single-threaded gateway contract."""
        ready = threading.Event()
        startup_error: list = []

        def _run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                try:
                    self._loop.run_until_complete(self.start())
                except BaseException as exc:  # surface EADDRINUSE etc. to the
                    startup_error.append(exc)  # caller, don't die silently
                    return
                finally:
                    ready.set()
                self._loop.run_forever()
            finally:
                self._loop.close()

        self._thread = threading.Thread(
            target=_run, name="gateway-server", daemon=True
        )
        self._thread.start()
        if not ready.wait(ready_timeout):
            raise RuntimeError("gateway server failed to start in time")
        if startup_error:
            self._thread.join(ready_timeout)
            self._loop = None
            self._thread = None
            raise startup_error[0]
        return self.host, self.port

    def stop_in_thread(self, timeout: float = 10.0) -> None:
        """Drain the threaded server and stop its loop/thread.  ``timeout``
        budgets the drain itself; the cross-thread wait gets headroom on
        top so a slow-but-progressing drain (e.g. a final flush that still
        has to capture its bucket) is not aborted midway."""
        if self._loop is None:
            return
        future = asyncio.run_coroutine_threadsafe(self.drain(timeout), self._loop)
        try:
            future.result(timeout + 30.0)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(timeout)
            self._loop = None
            self._thread = None

    # -- the pump ----------------------------------------------------------

    async def _pump_loop(self) -> None:
        # THE point of the transport: micro-batches flush on age without
        # any caller in the loop.  Engine failures fail their tickets
        # inside pump(); this guard only covers bookkeeping bugs so the
        # pump itself can never die and wedge the queue.
        while True:
            try:
                self.gateway.pump()
                if self.gateway.durability is not None:
                    # cadence snapshots ride the pump: skip (never block)
                    # while the previous background write is in flight
                    self.gateway.durability.maybe_snapshot()
                if self.gateway.control is not None:
                    # control ticks ride the pump too: the controller
                    # rate-limits itself via its tick interval
                    self.gateway.control.maybe_tick()
            except Exception:
                logger.exception("background pump failed; queue state kept")
            await asyncio.sleep(self.pump_interval_s)

    # -- connection handling ----------------------------------------------

    async def _handle(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._handlers.add(task)
        self._writers.add(writer)
        self._conn_seq += 1
        conn = _Connection(self, self._conn_seq, writer)
        try:
            while not self._draining:
                try:
                    line = await reader.readline()
                except ValueError as exc:  # line past max_line_bytes: framing
                    conn.send(_error_payload("?", exc))  # is lost, hang up
                    break
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                if self.enable_binary and line == _PREAMBLE_LINE:
                    # negotiation: the peer speaks bp1 — switch this
                    # connection to frame mode for the rest of its life
                    await self._serve_binary(reader, writer, conn)
                    break
                conn.dispatch(line)
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            conn.end_session()
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
            self._handlers.discard(task)

    async def _serve_binary(self, reader, writer, conn: "_Connection") -> None:
        """Frame loop for a connection that sent the bp1 preamble.

        Greets with a HELLO response frame (the client's confirmation
        that negotiation succeeded), then reads frames with
        ``readexactly``.  A framing-level violation (bad magic/version,
        oversize length field) means byte alignment is lost: best-effort
        error notice, then hang up.  Payload-level problems are answered
        per-frame inside ``dispatch_frame`` and keep the connection.
        """
        conn.binary = True
        self.gateway.telemetry.count("wire.conn_bp1")
        conn.send_frame(
            wire.OP_HELLO,
            wire.NO_REQUEST_ID,
            meta={
                "ok": True,
                "op": "hello",
                "protocol": "bp1",
                "version": wire.VERSION,
                "max_frame_bytes": self.max_line_bytes,
                "features": self.gateway.pool.features,
            },
        )
        await writer.drain()
        while not self._draining:
            try:
                frame = await wire.read_frame(reader, self.max_line_bytes)
            except asyncio.IncompleteReadError:
                return  # peer hung up (possibly mid-frame); _handle tears down
            except wire.WireProtocolError as exc:
                conn.send_frame(
                    0, wire.NO_REQUEST_ID, meta=_error_payload("?", exc),
                    flags=wire.FLAG_RESPONSE | wire.FLAG_ERROR,
                )
                return
            conn.dispatch_frame(frame)
            await writer.drain()


class _FrameScores:
    """Collects the *n* tickets of one pipelined SCORE frame and answers
    the frame — one response, ``n`` float32 scores — when the last ticket
    completes.  Tickets complete independently (a size-trigger flush can
    fire DURING the submit loop), so completion is counted, not awaited.
    If any submit raises mid-frame the whole frame answers one error via
    the dispatch error path and the collector is cancelled so callbacks
    from already-submitted tickets stay silent."""

    __slots__ = ("conn", "rid", "n", "span", "scores", "pending", "error",
                 "dead", "stage_ms")

    def __init__(self, conn: "_Connection", rid: int, n: int, span=None):
        self.conn = conn
        self.rid = rid
        self.n = n
        self.span = span
        self.scores = np.zeros(n, np.float32)
        self.pending = n
        self.error: Optional[BaseException] = None
        self.dead = False
        self.stage_ms = None

    def bind(self, i: int):
        def _completed(ticket) -> None:
            self.done(i, ticket)

        return _completed

    def done(self, i: int, ticket) -> None:
        if ticket.failed:
            if self.error is None:
                self.error = ticket.exception()
        else:
            self.scores[i] = ticket.score
            self.stage_ms = ticket.stage_ms
        self.pending -= 1
        if self.pending == 0 and not self.dead:
            self.finish()

    def cancel(self) -> None:
        self.dead = True

    def finish(self) -> None:
        if self.error is not None:
            self.conn.send(_error_payload("score", self.error), self.rid)
            return
        meta = {"ok": True, "op": "score", "n": self.n}
        threshold = self.conn.gateway.threshold
        if threshold is not None:
            meta["alert"] = [bool(s > threshold) for s in self.scores.tolist()]
        if self.span is not None:
            for stage, ms in (self.stage_ms or {}).items():
                self.span.stage(stage, ms)
            meta["trace"] = self.conn.gateway.tracer.finish(self.span).to_wire()
        self.conn.send_frame(
            wire.OP_SCORE, self.rid, meta=meta, data=self.scores.tobytes()
        )


class _Connection:
    """Per-connection protocol state: at most one pool session (the
    connection is the stream) plus response writing for in-flight
    one-shot tickets."""

    def __init__(self, server: GatewayServer, conn_id: int, writer):
        self.server = server
        self.gateway = server.gateway
        self.conn_id = conn_id
        self.writer = writer
        self.session_seq = 0
        self.stream_id = None  # ("conn", id, generation) when resident
        self.binary = False  # flipped when the bp1 preamble negotiates
        self._counted = False  # wire.conn_* counter emitted once per conn
        # strong refs to in-flight control tasks: the loop only keeps
        # weak ones, so an unreferenced task can be GC-cancelled mid-op
        self._control_tasks: set = set()

    # -- transport out -----------------------------------------------------

    def send(self, payload: dict, rid=None) -> None:
        """Protocol-aware response write: a JSON line, or — after bp1
        negotiation — the same dict as a response frame's meta (which is
        what lets every ``_op_*`` handler serve both protocols)."""
        if self.binary:
            opcode = wire.OPCODE_BY_NAME.get(payload.get("op"), 0)
            flags = wire.FLAG_RESPONSE
            if not payload.get("ok", True):
                flags |= wire.FLAG_ERROR
            if not isinstance(rid, int) or not 0 <= rid <= wire.NO_REQUEST_ID:
                rid = wire.NO_REQUEST_ID
            self.send_frame(opcode, rid, meta=payload, flags=flags)
            return
        if rid is not None:
            payload["id"] = rid
        if self.writer.is_closing():
            return
        try:
            self.writer.write((json.dumps(payload) + "\n").encode())
        except Exception:
            logger.exception("conn %d: response write failed", self.conn_id)

    def send_frame(
        self, opcode: int, rid: int, meta: Optional[dict] = None,
        data: bytes = b"", flags: int = wire.FLAG_RESPONSE,
    ) -> None:
        if self.writer.is_closing():
            return
        try:
            self.writer.write(
                wire.pack_frame(opcode, rid, meta=meta, data=data, flags=flags)
            )
        except Exception:
            logger.exception("conn %d: frame write failed", self.conn_id)

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, line: bytes) -> None:
        # server-side wire cost per request: JSON decode + handler +
        # response encode/queue (the transport tax minus kernel + client
        # time) — the ``wire_ms`` stage histogram when detail is on
        tel = self.gateway.telemetry
        t_in = tel.now() if tel.detail else 0.0
        tel.count("wire.req_json")
        if not self._counted:
            self._counted = True
            tel.count("wire.conn_json")
        try:
            req = json.loads(line)
            op = req.get("op")
        except (ValueError, AttributeError) as exc:
            self.send(_error_payload("?", exc))
            return
        rid = req.get("id")
        handler = getattr(self, f"_op_{op}", None) if isinstance(op, str) else None
        if handler is None:
            self.send(
                _error_payload(str(op), ValueError(f"unknown op {op!r}")), rid
            )
            return
        try:
            handler(req, rid)
        except Exception as exc:  # per-request isolation: one bad request
            self.send(_error_payload(op, exc), rid)  # never drops the conn
        if tel.detail:
            tel.observe_stage("wire_ms", (tel.now() - t_in) * 1e3)

    def dispatch_frame(self, frame: wire.Frame) -> None:
        """Binary-mode request dispatch.  SCORE/STEP get dedicated
        raw-float32 handlers; every other opcode rebuilds the JSON-era
        request dict from the frame's meta and reuses ``_op_*``."""
        tel = self.gateway.telemetry
        t_in = tel.now() if tel.detail else 0.0
        tel.count("wire.req_bp1")
        rid = frame.req_id
        op = wire.NAME_BY_OPCODE.get(frame.opcode)
        if op is None or frame.opcode == wire.OP_HELLO:
            # hello is the server's greeting, never a request op
            exc = ValueError(f"unknown opcode 0x{frame.opcode:02x}")
            self.send_frame(
                frame.opcode, rid, meta=_error_payload("?", exc),
                flags=wire.FLAG_RESPONSE | wire.FLAG_ERROR,
            )
            return
        try:
            meta, data = wire.split_payload(frame.payload)
        except wire.WireProtocolError as exc:
            # the length field was honest (we read a complete frame), so
            # stream alignment holds: answer an error, keep the conn
            self.send_frame(
                frame.opcode, rid, meta=_error_payload(op, exc),
                flags=wire.FLAG_RESPONSE | wire.FLAG_ERROR,
            )
            return
        try:
            if frame.opcode == wire.OP_SCORE:
                self._frame_score(meta, data, rid)
            elif frame.opcode == wire.OP_STEP:
                self._frame_step(meta, data, rid)
            else:
                req = dict(meta)
                req["op"] = op
                getattr(self, f"_op_{op}")(req, rid)
        except Exception as exc:  # same per-request isolation as dispatch()
            self.send(_error_payload(op, exc), rid)
        if tel.detail:
            tel.observe_stage("wire_ms", (tel.now() - t_in) * 1e3)

    def _frame_score(self, meta: dict, data, rid: int) -> None:
        """A SCORE frame: ``n`` windows of shape ``(t, f)`` as one raw
        float32 block.  ``np.frombuffer`` makes ``windows`` a view of
        the recv payload; the only copy happens when the batcher packs
        its bucket pad buffer."""
        if "series" in meta and not len(data):
            # JSON-style request tunneled through a generic meta frame
            # (client.request("score", series=...)) — slow path, but it
            # keeps every JSON request (trace included) expressible over
            # bp1; the response frames through the protocol-aware send()
            req = dict(meta)
            req["op"] = "score"
            self._op_score(req, rid)
            return
        n = meta.get("n", 1)
        t = meta.get("t")
        f = meta.get("f", self.gateway.pool.features)
        if (not isinstance(n, int) or not isinstance(t, int)
                or not isinstance(f, int) or n < 0 or t < 1 or f < 1):
            raise ValueError(
                f"score frame needs integer meta n>=0, t>=1, f>=1; "
                f"got n={n!r} t={t!r} f={f!r}"
            )
        if n == 0:
            # an empty pipelined batch is legal and answers immediately
            self.send_frame(
                wire.OP_SCORE, rid, meta={"ok": True, "op": "score", "n": 0}
            )
            return
        windows = wire.decode_f32(data, (n, t, f))
        tid = meta.get("trace")
        span = (self.gateway.tracer.start("score", trace_id=str(tid))
                if tid is not None and n == 1 else None)
        if span is not None:
            span.mark("dispatch")
        collector = _FrameScores(self, rid, n, span)
        priority = meta.get("priority")
        tenant = meta.get("tenant")
        try:
            for i in range(n):
                ticket = self.gateway.submit(
                    windows[i], priority=priority, tenant=tenant
                )
                ticket.add_done_callback(collector.bind(i))
        except Exception:
            collector.cancel()  # one error answers the whole frame
            raise

    def _frame_step(self, meta: dict, data, rid: int) -> None:
        """A STEP frame: ``t`` consecutive samples for this connection's
        session in one frame (amortizes the round-trip; the response
        returns every intermediate running error).  Durable sessions get
        their ``seq``/``token`` from the LAST sample, which is exactly
        what a replaying client needs."""
        feats = self.gateway.pool.features
        if "x" in meta and not len(data):
            # JSON-style request tunneled through a generic meta frame
            req = dict(meta)
            req["op"] = "step"
            self._op_step(req, rid)
            return
        k = meta.get("t", 1)
        if not isinstance(k, int) or k < 1:
            raise ValueError(f"step frame needs integer meta t>=1, got {k!r}")
        count = len(data) // 4
        if k == 1 and count != feats:
            # same message the JSON protocol's shape check produces
            raise ValueError(
                f"expected sample shape ({feats},), got ({count},)"
            )
        xs = wire.decode_f32(data, (k, feats))
        if self.stream_id is None:
            dur = self.gateway.durability
            if dur is not None:
                self.stream_id, _ = dur.admit()
            else:
                self.session_seq += 1
                sid = ("conn", self.conn_id, self.session_seq)
                self.gateway.admit(sid)
                self.stream_id = sid
        errors = np.zeros(k, np.float32)
        seq = token = None
        dur = self._durable
        for i in range(k):
            if dur is not None:
                running, seq, token = dur.step(self.stream_id, xs[i])
            else:
                running = self.gateway.step({self.stream_id: xs[i]})[self.stream_id]
            errors[i] = running
        meta_out = {"ok": True, "op": "step", "t": k,
                    "running_error": float(errors[-1])}
        if token is not None:
            meta_out["seq"] = seq
            meta_out["token"] = token
        threshold = self.gateway.threshold
        if threshold is not None:
            meta_out["alert"] = [bool(e > threshold) for e in errors.tolist()]
        self.send_frame(wire.OP_STEP, rid, meta=meta_out, data=errors.tobytes())

    def _alert_field(self, payload: dict, value: float) -> dict:
        threshold = self.gateway.threshold
        if threshold is not None:
            payload["alert"] = bool(value > threshold)
        return payload

    # -- streaming session ops --------------------------------------------

    @property
    def _durable(self):
        """The DurableSessions coordinator IF this connection's session is
        a durable one (durable ids are strings; legacy per-connection ids
        are tuples, so a server whose durability was enabled mid-flight
        never mixes the two paths on one session)."""
        dur = self.gateway.durability
        if dur is not None and isinstance(self.stream_id, str):
            return dur
        return None

    def _op_step(self, req: dict, rid) -> None:
        # optional tracing: a "trace" field opts this request into a span
        # (unknown to older peers, ignored by them — backward compatible)
        tid = req.get("trace")
        span = (self.gateway.tracer.start("step", trace_id=str(tid))
                if tid is not None else None)
        # validate the payload BEFORE admitting: a malformed first step
        # must not pin a pool slot that never serves
        x = np.asarray(req["x"], np.float32)
        feats = self.gateway.pool.features
        if x.shape != (feats,):
            raise ValueError(f"expected sample shape ({feats},), got {x.shape}")
        dur = self.gateway.durability
        if self.stream_id is None:
            if dur is not None:
                self.stream_id, _ = dur.admit()  # PoolFullError -> error resp
            else:
                self.session_seq += 1
                sid = ("conn", self.conn_id, self.session_seq)
                self.gateway.admit(sid)
                self.stream_id = sid
        if span is not None:
            span.mark("dispatch")
        if self._durable is not None:
            running, seq, token = self._durable.step(self.stream_id, x)
            payload = {"ok": True, "op": "step", "running_error": running,
                       "seq": seq, "token": token}
        else:
            running = self.gateway.step({self.stream_id: x})[self.stream_id]
            payload = {"ok": True, "op": "step", "running_error": running}
        if span is not None:
            span.mark("compute")
            payload["trace"] = self.gateway.tracer.finish(span).to_wire()
        self.send(self._alert_field(payload, running), rid)

    def _op_close(self, req: dict, rid) -> None:
        if self.stream_id is None:
            raise ValueError("no open session on this connection (step first)")
        if self._durable is not None:
            final = self._durable.close(self.stream_id)  # forgotten: tokens die
        else:
            final = self.gateway.evict(self.stream_id)
        self.stream_id = None
        self.send(
            self._alert_field({"ok": True, "op": "close", "final": final}, final), rid
        )

    def _op_resume(self, req: dict, rid) -> None:
        dur = self.gateway.durability
        if dur is None:
            raise ValueError("durability is not enabled on this server")
        if self.stream_id is not None:
            raise ValueError(
                "this connection already carries a session; close it "
                "before resuming another"
            )
        out = dur.resume(req["token"])  # token errors -> dispatch error path
        self.stream_id = out["sid"]
        payload = {"ok": True, "op": "resume", "seq": out["seq"],
                   "running_error": out["running_error"],
                   "token": out["token"]}
        self.send(self._alert_field(payload, out["running_error"]), rid)

    def end_session(self) -> None:
        """Connection teardown: a durable session is PARKED (exact state,
        resumable by token); a legacy session is evicted (the final score
        is unreported on abrupt drops)."""
        if self.stream_id is None:
            return
        try:
            if self._durable is not None:
                self._durable.suspend(self.stream_id)
            else:
                self.gateway.evict(self.stream_id)
        except Exception:
            logger.exception("conn %d: eviction at teardown failed", self.conn_id)
        finally:
            self.stream_id = None

    # -- one-shot scoring --------------------------------------------------

    def _op_score(self, req: dict, rid) -> None:
        tid = req.get("trace")
        span = (self.gateway.tracer.start("score", trace_id=str(tid))
                if tid is not None else None)
        series = np.asarray(req["series"], np.float32)
        if span is not None:
            # decode + validation; marked BEFORE submit so an inline
            # size-trigger flush is attributed to the ticket's own
            # queue_wait/assemble/compute stages, never double-counted
            span.mark("dispatch")
        # optional admission fields (None for legacy clients -> flat path)
        ticket = self.gateway.submit(
            series, priority=req.get("priority"), tenant=req.get("tenant"),
        )  # overload/shape/shed errors -> dispatch error path

        def _completed(t) -> None:
            if t.failed:
                self.send(_error_payload("score", t.exception()), rid)
            else:
                payload = self._alert_field(
                    {"ok": True, "op": "score", "score": t.score}, t.score
                )
                if span is not None:
                    for stage, ms in (t.stage_ms or {}).items():
                        span.stage(stage, ms)
                    payload["trace"] = \
                        self.gateway.tracer.finish(span).to_wire()
                self.send(payload, rid)

        # fires now if submit's size-trigger already flushed the bucket,
        # later from the background pump / drain otherwise
        ticket.add_done_callback(_completed)

    # -- control ops -------------------------------------------------------

    def _complete(self, op: str, result, rid, wrap) -> None:
        """Answer ``op`` from a provider's result.  An awaitable (worker-front
        providers cross a control pipe) is answered when its task completes —
        like score tickets, possibly after later requests' responses."""
        if not inspect.isawaitable(result):
            self.send(wrap(result), rid)
            return
        awaitable = result

        async def run() -> None:
            try:
                result = await awaitable
            except Exception as exc:
                self.send(_error_payload(op, exc), rid)
            else:
                self.send(wrap(result), rid)

        task = asyncio.get_running_loop().create_task(run())
        self._control_tasks.add(task)
        task.add_done_callback(self._control_tasks.discard)

    def _op_recalibrate(self, req: dict, rid) -> None:
        kw = {}
        if "threshold" in req:
            kw["threshold"] = req["threshold"]
        provider = self.server.recalibrate_provider
        if provider is None:
            out = self.gateway.recalibrate(**kw)
            self.send({"ok": True, "op": "recalibrate", **out}, rid)
            return
        # worker-front mode: the swap must reach every worker process or
        # acceptors would disagree about alerts — fan out, then answer
        self._complete(
            "recalibrate", provider(**kw), rid,
            lambda out: {"ok": True, "op": "recalibrate", **out},
        )

    def _op_stats(self, req: dict, rid) -> None:
        provider = self.server.stats_provider
        if provider is None:
            self.send({"ok": True, "op": "stats",
                       "stats": self.gateway.stats()}, rid)
            return
        # worker-front mode: answer with the AGGREGATED front snapshot
        self._complete(
            "stats", provider(), rid,
            lambda stats: {"ok": True, "op": "stats", "stats": stats},
        )

    def _op_snapshot(self, req: dict, rid) -> None:
        dur = self.gateway.durability
        if dur is None:
            raise ValueError("durability is not enabled on this server")
        out = dur.snapshot_now(wait=True)  # synchronous: callers use this
        self.send({"ok": True, "op": "snapshot", **out}, rid)  # as a barrier

    def _op_ping(self, req: dict, rid) -> None:
        self.send({"ok": True, "op": "ping"}, rid)


__all__ = ["GatewayServer"]
