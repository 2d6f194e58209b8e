"""Synchronous client for :class:`~repro_torch.gateway.server.GatewayServer`.

Counterpart of ``repro/gateway/client.py`` (numpy and the stdlib only; it
talks to either package's server).  Stdlib-socket counterpart of the wire
protocols documented in ``server.py`` and
:mod:`repro_torch.gateway.wire` — used by the transport tests and
``chip_smoke.py``.  One connection carries at most one streaming session (the
server maps connections to pool sessions) plus any number of in-flight
one-shot score requests.

Protocol negotiation — ``protocol="auto"`` (the default) opens the
connection with the 4-byte bp1 preamble: a bp1-capable server answers a
binary ``HELLO`` frame and the connection runs the binary protocol
(:attr:`protocol` becomes ``"bp1"``); a legacy JSON-lines server answers
a JSON error line instead, which the client consumes and silently falls
back to JSON on the same connection.  ``protocol="json"`` skips the
preamble entirely — the connection is byte-for-byte a JSON-lines client —
and ``protocol="binary"`` raises if the server can't negotiate bp1.
Either way every public method below behaves identically; on bp1 the
hot ops (``submit``/``score``/``step``) travel as raw-float32 frames
(no float lists) and :meth:`score_many`/:meth:`step_many` additionally
pipeline many windows per frame.

Responses can arrive out of submission order (``score`` answers when the
server's micro-batcher flushes), so the client matches responses to
requests by ``id``: :meth:`submit` returns a request id immediately and
:meth:`collect` blocks until that id's response has been read, parking
any other responses it sees on the way.  On bp1 the id travels in the
frame header; pipelined frames complete out of order the same way.

Durability (server-side ``enable_durability``): ``step`` responses then
carry ``seq`` + a signed resumption ``token``, which the client tracks
(:attr:`session_token`) alongside a bounded replay buffer of its last
``replay_window`` samples.  After losing the connection — or the whole
worker — open a NEW client and call :meth:`resume` with the old client's
token/buffer: the server restores the session from its latest snapshot
and the client transparently re-steps the buffered samples past the
snapshot position, so scores continue exactly as if nothing died.
"""
from __future__ import annotations

import json
import socket
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from repro_torch.gateway import wire


class ReplayWindowExceededError(RuntimeError):
    """The server's snapshot is older than the oldest sample in the
    client's replay buffer — the gap cannot be replayed.  Raise the
    snapshot cadence or the client's ``replay_window``."""


class GatewayClientError(RuntimeError):
    """An ``ok: false`` response; ``.error`` holds the server-side
    exception name (e.g. ``"GatewayOverloadedError"``)."""

    def __init__(self, error: str, message: str):
        super().__init__(f"{error}: {message}")
        self.error = error
        self.message = message


class GatewayClient:
    """One connection to a running gateway server.

    >>> with GatewayClient(host, port) as client:
    ...     client.step(x_t)["running_error"]     # streaming session
    ...     client.end_session()["final"]
    ...     client.score(window)                  # one-shot (blocks on flush)
    ...     rids = [client.submit(w) for w in windows]   # concurrent
    ...     scores = [client.collect(r)["score"] for r in rids]
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 30.0, replay_window: int = 256,
                 protocol: str = "auto"):
        if protocol not in ("auto", "binary", "json"):
            raise ValueError(
                f"protocol must be 'auto', 'binary' or 'json', got {protocol!r}"
            )
        self._sock = socket.create_connection((host, port), timeout=timeout)
        # request/response protocol: never let Nagle hold a small frame
        # back waiting for the previous one's ACK (the asyncio server side
        # already sets this on its transports)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        self._next_id = 0
        self._parked: dict = {}  # id -> response that arrived out of order
        # durability bookkeeping: the freshest resumption token plus the
        # last `replay_window` (seq -> sample) pairs, enough to re-step
        # past any snapshot at most `replay_window` steps behind
        self.replay_window = int(replay_window)
        self._token: Optional[str] = None
        self._seq = 0
        self._replay: "OrderedDict[int, list]" = OrderedDict()
        #: Active wire protocol after negotiation: "bp1" or "json".
        self.protocol = "json"
        #: The server's HELLO meta when bp1 negotiated (version, limits).
        self.server_info: dict = {}
        if protocol != "json":
            self._negotiate(require=(protocol == "binary"))

    # -- wire --------------------------------------------------------------

    def _negotiate(self, require: bool) -> None:
        """Send the bp1 preamble and read the server's verdict: the first
        response byte is either the frame magic (bp1 negotiated — consume
        the HELLO frame) or ``{`` (a legacy server's JSON error line for
        the undecodable preamble — consume it and fall back to JSON)."""
        self._sock.sendall(wire.PREAMBLE)
        head = self._rfile.read(1)
        if not head:
            raise ConnectionError("server closed the connection while negotiating")
        if head == wire.MAGIC[:1]:
            opcode, flags, _rid, length = wire.unpack_header(
                head + self._read_exact(wire.HEADER_SIZE - 1)
            )
            meta, _ = wire.split_payload(self._read_exact(length))
            if opcode != wire.OP_HELLO or meta.get("version") != wire.VERSION:
                raise GatewayClientError(
                    "ProtocolError",
                    f"unexpected bp1 greeting: opcode 0x{opcode:02x}, meta {meta}",
                )
            self.protocol = "bp1"
            self.server_info = meta
            return
        line = head + self._rfile.readline()
        if require:
            raise GatewayClientError(
                "ProtocolError",
                f"server does not speak bp1 (answered {line[:80]!r})",
            )
        self.protocol = "json"

    def _send(self, payload: dict) -> int:
        rid = self._next_id
        self._next_id += 1
        payload["id"] = rid
        self._sock.sendall((json.dumps(payload) + "\n").encode())
        return rid

    def _send_frame(self, opcode: int, meta: Optional[dict] = None,
                    data: bytes = b"") -> int:
        rid = self._next_id
        self._next_id += 1
        self._sock.sendall(wire.pack_frame(opcode, rid, meta=meta, data=data))
        return rid

    def _read_exact(self, n: int) -> bytes:
        buf = self._rfile.read(n) if n else b""
        if len(buf) < n:
            raise ConnectionError("server closed the connection")
        return buf

    def _read_frame(self) -> dict:
        """Read one frame and normalize it into the same dict shape the
        JSON protocol produces, so everything above :meth:`collect` is
        protocol-agnostic: header req_id -> ``id``, meta -> fields, raw
        float32 data -> ``scores`` (score) / ``running_errors`` (step),
        plus the scalar ``score``/``alert`` aliases for single-window
        frames."""
        opcode, flags, rid, length = wire.unpack_header(
            self._read_exact(wire.HEADER_SIZE)
        )
        meta, data = wire.split_payload(self._read_exact(length))
        decoded = dict(meta)
        decoded["id"] = rid
        if flags & wire.FLAG_ERROR:
            decoded.setdefault("ok", False)
        else:
            decoded.setdefault("ok", True)
            decoded.setdefault("op", wire.NAME_BY_OPCODE.get(opcode))
            values = (np.frombuffer(data, "<f4").tolist() if len(data) else [])
            if opcode == wire.OP_SCORE:
                decoded["scores"] = values
                if len(values) == 1:
                    decoded["score"] = values[0]
                    if isinstance(decoded.get("alert"), list):
                        decoded["alert"] = decoded["alert"][0]
            elif opcode == wire.OP_STEP:
                decoded["running_errors"] = values
                if len(values) == 1 and isinstance(decoded.get("alert"), list):
                    decoded["alert"] = decoded["alert"][0]
        return decoded

    def _read_until(self, rid: int) -> dict:
        while rid not in self._parked:
            if self.protocol == "bp1":
                decoded = self._read_frame()
                got = decoded["id"]
                if got == wire.NO_REQUEST_ID and not decoded.get("ok"):
                    # connection-level failure (framing loss): the server
                    # answers on the sentinel id and hangs up
                    raise GatewayClientError(
                        decoded.get("error", "UnknownError"),
                        decoded.get("message", ""),
                    )
                self._parked[got] = decoded
                continue
            line = self._rfile.readline()
            if not line:
                raise ConnectionError("server closed the connection")
            resp = json.loads(line)
            if resp.get("id") is None and not resp.get("ok"):
                # connection-level failure (unparseable / over-long line):
                # the server answers without an id and hangs up — surface
                # its reason instead of a bare ConnectionError later
                raise GatewayClientError(
                    resp.get("error", "UnknownError"), resp.get("message", "")
                )
            self._parked[resp.get("id")] = resp
        return self._parked.pop(rid)

    def collect(self, rid: int) -> dict:
        """Block until request ``rid``'s response arrives; raises
        :class:`GatewayClientError` on ``ok: false``."""
        resp = self._read_until(rid)
        if not resp.get("ok"):
            raise GatewayClientError(
                resp.get("error", "UnknownError"), resp.get("message", "")
            )
        return resp

    def request(self, op: str, **fields) -> dict:
        """Send one request and wait for its response.  On bp1 the same
        dict travels as a generic meta frame (unknown ``op`` names get an
        unassigned opcode so the server still answers the error — JSON
        parity); ``score``/``step`` tunnel their float lists in meta,
        which works but skips the raw-float32 fast path — prefer
        :meth:`submit`/:meth:`step`."""
        if self.protocol == "bp1":
            opcode = wire.OPCODE_BY_NAME.get(op, 0x7F)
            return self.collect(self._send_frame(opcode, meta=fields or None))
        return self.collect(self._send({"op": op, **fields}))

    # -- streaming session -------------------------------------------------

    @property
    def session_token(self) -> Optional[str]:
        """The freshest resumption token (None before the first step, or
        on a server without durability)."""
        return self._token

    @property
    def session_seq(self) -> int:
        return self._seq

    def replay_buffer(self) -> list:
        """``(seq, sample)`` pairs this client could replay — hand these
        (with :attr:`session_token`) to a NEW client's :meth:`resume`
        when this one's connection/worker died."""
        return [(seq, list(x)) for seq, x in self._replay.items()]

    def _track(self, resp: dict, x: list) -> dict:
        if "token" in resp:
            self._token = resp["token"]
            self._seq = int(resp.get("seq", self._seq))
            if x is not None:
                self._replay[self._seq] = x
                while len(self._replay) > self.replay_window:
                    self._replay.popitem(last=False)
        return resp

    def step(self, x_t) -> dict:
        """Advance this connection's pool session one timestep; returns the
        response (``running_error`` and, when calibrated, ``alert``; with
        durability also ``seq`` + ``token``, tracked on the client)."""
        if self.protocol == "bp1":
            arr = np.ascontiguousarray(x_t, dtype="<f4")
            rid = self._send_frame(wire.OP_STEP, meta={"t": 1},
                                   data=arr.tobytes())
            return self._track(self.collect(rid), arr.tolist())
        x = np.asarray(x_t, np.float32).tolist()
        return self._track(self.request("step", x=x), x)

    def step_many(self, xs) -> list:
        """Advance the session ``len(xs)`` timesteps; returns every
        intermediate running error.  On bp1 all samples travel in ONE
        frame (one round-trip instead of ``len(xs)``); on JSON this
        degrades to a per-sample loop with identical results.  Durable
        sessions track the frame's token/seq against each sample's
        implied position, so :meth:`resume` replay stays exact."""
        if self.protocol != "bp1":
            return [float(self.step(x)["running_error"]) for x in xs]
        arr = np.ascontiguousarray(xs, dtype="<f4")
        if arr.ndim != 2:
            raise ValueError(f"expected (k, F) samples, got shape {arr.shape}")
        k = arr.shape[0]
        if k == 0:
            return []
        rid = self._send_frame(wire.OP_STEP, meta={"t": k}, data=arr.tobytes())
        decoded = self.collect(rid)
        errors = decoded.get("running_errors") or []
        if "token" in decoded:
            # the frame's seq/token cover its LAST sample; samples i of k
            # sit at seq (last - k + 1 + i) in the replay buffer
            self._token = decoded["token"]
            last = self._seq = int(decoded.get("seq", self._seq))
            for i in range(k):
                self._replay[last - k + 1 + i] = arr[i].tolist()
            while len(self._replay) > self.replay_window:
                self._replay.popitem(last=False)
        return [float(e) for e in errors]

    def end_session(self) -> dict:
        """Evict the session; returns the response (``final`` score).  On
        a durable server this CLOSES the session — its tokens stop
        resuming once old snapshots age out."""
        resp = self.request("close")
        self._token = None
        self._seq = 0
        self._replay.clear()
        return resp

    def resume(self, token: Optional[str] = None,
               replay: Optional[Sequence] = None) -> dict:
        """Revive a durable session on THIS connection from ``token``
        (default: this client's own last token — useful after a plain
        reconnect; pass the dead client's token/``replay_buffer()`` when
        migrating).  Replays buffered samples newer than the server's
        snapshot position, so the session continues exactly where the old
        connection stopped.  Returns ``{"seq": <position after replay>,
        "running_error": .., "replayed": <n>}``."""
        token = self._token if token is None else token
        if token is None:
            raise ValueError("no resumption token (pass one, or step first)")
        entries = (list(self._replay.items()) if replay is None
                   else [(int(s), list(x)) for s, x in replay])
        resp = self.request("resume", token=token)
        self._token = resp.get("token", token)
        base = self._seq = int(resp["seq"])
        todo = sorted((s, x) for s, x in entries if s > base)
        if todo:
            expect = list(range(base + 1, base + 1 + len(todo)))
            if [s for s, _ in todo] != expect:
                raise ReplayWindowExceededError(
                    f"snapshot is at seq {base} but the replay buffer "
                    f"covers {todo[0][0]}..{todo[-1][0]} — "
                    f"{todo[0][0] - base - 1} step(s) are unrecoverable"
                )
        self._replay = OrderedDict(
            (s, x) for s, x in entries if s <= base
        )
        out = dict(resp)
        for _, x in todo:
            out = self.step(x)
        return {
            "seq": self._seq,
            "running_error": out["running_error"],
            "replayed": len(todo),
            "alert": out.get("alert"),
        }

    # -- one-shot scoring --------------------------------------------------

    def submit(self, series, *, priority: Optional[int] = None,
               tenant: Optional[str] = None) -> int:
        """Fire a one-shot score request; returns its id for
        :meth:`collect` (responses arrive on the server's flush cadence).
        ``priority`` (0 = highest class) and ``tenant`` feed the server's
        admission controller when one is attached; both are omitted from
        the wire payload when None, so legacy traffic is byte-identical.
        On bp1 the window travels as one raw-float32 SCORE frame."""
        if self.protocol == "bp1":
            arr = np.ascontiguousarray(series, dtype="<f4")
            if arr.ndim != 2:
                raise ValueError(f"expected (T, F) window, got shape {arr.shape}")
            meta = {"n": 1, "t": int(arr.shape[0]), "f": int(arr.shape[1])}
            if priority is not None:
                meta["priority"] = int(priority)
            if tenant is not None:
                meta["tenant"] = str(tenant)
            return self._send_frame(wire.OP_SCORE, meta=meta, data=arr.tobytes())
        payload = {"op": "score",
                   "series": np.asarray(series, np.float32).tolist()}
        if priority is not None:
            payload["priority"] = int(priority)
        if tenant is not None:
            payload["tenant"] = str(tenant)
        return self._send(payload)

    def score(self, series, *, priority: Optional[int] = None,
              tenant: Optional[str] = None) -> float:
        """Submit one window and block for its score."""
        return float(self.collect(
            self.submit(series, priority=priority, tenant=tenant)
        )["score"])

    def traced_score(self, series) -> dict:
        """One-shot score carrying a trace id, returning the full span.

        The request's ``trace`` field opts the server into span capture
        (old servers simply ignore it — the field is additive); the
        response's ``trace.stages`` carries the server-side breakdown
        (``dispatch`` / ``queue_wait`` / ``assemble`` / ``compute``).
        Client-side this method measures ``serialize`` (ndarray -> JSON
        text) and attributes the end-to-end remainder to ``wire``
        (sockets + framing + readline), so the returned stages sum to the
        observed end-to-end wire latency.

        Returns ``{"score", "trace_id", "stages": {name: ms}, "e2e_ms",
        "server_ms", "alert"}``.
        """
        t0 = time.perf_counter()
        rid = self._next_id
        self._next_id += 1
        tid = f"c{rid:x}"
        if self.protocol == "bp1":
            arr = np.ascontiguousarray(series, dtype="<f4")
            buf = wire.pack_frame(
                wire.OP_SCORE, rid,
                meta={"n": 1, "t": int(arr.shape[0]), "f": int(arr.shape[1]),
                      "trace": tid},
                data=arr.tobytes(),
            )
        else:
            buf = (json.dumps({
                "op": "score", "id": rid, "trace": tid,
                "series": np.asarray(series, np.float32).tolist(),
            }) + "\n").encode()
        t_serialized = time.perf_counter()
        self._sock.sendall(buf)
        resp = self.collect(rid)
        e2e_ms = (time.perf_counter() - t0) * 1e3
        trace = resp.get("trace") or {}
        stages = {"serialize": (t_serialized - t0) * 1e3}
        stages.update(trace.get("stages") or {})
        # everything not attributed above is transit: kernel buffers,
        # framing, the reply's decode.  Clamped at 0 — server stages are
        # sub-intervals of the client's wait, so the remainder is
        # non-negative up to clock granularity.
        stages["wire"] = max(0.0, e2e_ms - sum(stages.values()))
        return {
            "score": float(resp["score"]),
            "trace_id": str(trace.get("id", tid)),
            "stages": stages,
            "e2e_ms": e2e_ms,
            "server_ms": trace.get("total_ms"),
            "alert": resp.get("alert"),
        }

    def score_many(self, windows: Sequence, *,
                   windows_per_frame: int = 64) -> list:
        """Submit every window up front (so the server can micro-batch
        them), then collect all scores in submission order.

        On bp1 this is the pipelined fast path: consecutive same-shape
        windows are packed ``windows_per_frame`` at a time into single
        SCORE frames (one header + one contiguous float32 block for the
        whole group), all frames are written before any response is
        read, and responses are matched by frame id — so the depth-1
        sweep of the ``gateway_binary`` benchmark is literally
        ``windows_per_frame=1``.  On JSON this degrades to the
        submit/collect loop with identical results."""
        if self.protocol != "bp1":
            rids = [self.submit(w) for w in windows]
            return [float(self.collect(rid)["score"]) for rid in rids]
        depth = int(windows_per_frame)
        if depth < 1:
            raise ValueError(f"windows_per_frame must be >= 1, got {depth}")
        arrs = [np.ascontiguousarray(w, dtype="<f4") for w in windows]
        for arr in arrs:
            if arr.ndim != 2:
                raise ValueError(
                    f"expected (T, F) windows, got shape {arr.shape}"
                )
        frames = []  # (rid, window count) in submission order
        i = 0
        while i < len(arrs):
            j = i + 1
            while (j < len(arrs) and j - i < depth
                   and arrs[j].shape == arrs[i].shape):
                j += 1
            chunk = arrs[i:j]
            t, f = chunk[0].shape
            data = (np.stack(chunk).tobytes() if len(chunk) > 1
                    else chunk[0].tobytes())
            rid = self._send_frame(
                wire.OP_SCORE,
                meta={"n": len(chunk), "t": int(t), "f": int(f)},
                data=data,
            )
            frames.append((rid, len(chunk)))
            i = j
        scores: list = []
        for rid, count in frames:
            decoded = self.collect(rid)
            got = decoded.get("scores") or []
            if len(got) != count:
                raise GatewayClientError(
                    "ProtocolError",
                    f"frame {rid} answered {len(got)} scores for {count} windows",
                )
            scores.extend(float(s) for s in got)
        return scores

    # -- control -----------------------------------------------------------

    def stats(self) -> dict:
        return self.request("stats")["stats"]

    def recalibrate(self, threshold: Optional[float]) -> dict:
        """Swap the server-side detection threshold live (None disables
        alerting); resident sessions keep serving."""
        return self.request("recalibrate", threshold=threshold)

    def ping(self) -> bool:
        return bool(self.request("ping")["ok"])

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["GatewayClient", "GatewayClientError", "ReplayWindowExceededError"]
