"""Micro-batching request queue for one-shot scoring.

Counterpart of ``repro/gateway/queue.py``.  One-shot ``score`` requests (a single (T, F) window each) are coalesced
into padded, shape-bucketed micro-batches — the serving-layer analogue of
the paper's inter-module FIFOs keeping the datapath fed.  Requests bucket
by sequence length (next power-of-two ladder), pad to the bucket
boundary, and flush when a bucket reaches ``max_batch`` or its oldest
request has waited ``max_wait_ms``.  Every flush runs the engine's
masked score on a FIXED (lanes, bucket_T, F) shape — ``lanes`` is
``max_batch`` rounded up to a per-device multiple of the engine's
placement (``max_batch`` itself on one GPU) — so the set of shapes is
bounded by the ladder; padding lanes are masked out of the scores (LSTM
causality makes end-padding exact, see ``Engine.score_masked``).  Under
the ``fused`` schedule each flush launches K1 6 x bucket_T times for a
six-layer model; a capturing engine captures each such shape once and
replays one CUDA graph per flush.

Backpressure: ``submit`` raises :class:`GatewayOverloadedError` once
``max_queue`` requests are pending (admission control, not silent
buffering) and ValueError past ``max_seq_len`` (each power-of-two bucket
beyond the ladder would mint a fresh shape — oversized windows are a
caller error).  The queue is caller-driven
(call :meth:`pump` from the serve loop, or let a transport's background
pump task do it) and single-threaded by design; ``clock`` is injectable
for tests.

Tickets complete future-style: a flush either resolves every taken
ticket with its score or *fails* them all with the engine's exception —
requests never sit unresolved after leaving the queue, which is what
lets an async transport await tickets instead of polling.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.engine.base import Engine
from repro_torch.gateway.telemetry import Telemetry
from repro_torch.obs.histogram import Histogram

logger = logging.getLogger(__name__)

# bucket ladder for sequence lengths; lengths beyond the last rung double
_BUCKET_LADDER = (8, 16, 32, 64, 128, 256, 512, 1024)


class GatewayOverloadedError(RuntimeError):
    """The request queue is full (``max_queue`` pending) — shed or retry."""


class Ticket:
    """Future-style handle for one submitted request.

    A ticket is *resolved* (score available) or *failed* (the flush's
    engine exception stored) exactly once, at flush time.  Completion
    callbacks registered via :meth:`add_done_callback` fire synchronously
    on whichever path finishes the ticket — success AND error — so a
    transport can write the response from the callback without polling.
    """

    __slots__ = ("t_submit", "stage_ms", "_score", "_error", "_callbacks")

    def __init__(self, t_submit: float):
        self.t_submit = t_submit
        # stage timing breakdown stamped at flush time (queue_wait /
        # assemble / compute, in ms) — folded into the request's span when
        # the caller traced it; None until the ticket's flush runs
        self.stage_ms: Optional[dict] = None
        self._score: Optional[float] = None
        self._error: Optional[BaseException] = None
        self._callbacks: list = []

    @property
    def done(self) -> bool:
        """True once the ticket is resolved or failed."""
        return self._score is not None or self._error is not None

    @property
    def failed(self) -> bool:
        return self._error is not None

    def exception(self) -> Optional[BaseException]:
        """The flush failure that killed this request (None if none yet)."""
        return self._error

    @property
    def score(self) -> float:
        if self._error is not None:
            raise self._error
        if self._score is None:
            raise RuntimeError("request not scored yet; pump()/flush() the queue")
        return self._score

    def add_done_callback(self, fn: Callable[["Ticket"], None]) -> None:
        """Call ``fn(ticket)`` when the ticket completes (immediately if it
        already has).  Callback exceptions are logged, never propagated —
        one broken consumer must not wedge a flush for its batchmates."""
        if self.done:
            self._run_callback(fn)
        else:
            self._callbacks.append(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception:
            logger.exception("ticket completion callback raised")

    def _finish(self) -> None:
        callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            self._run_callback(fn)

    def _resolve(self, score: float) -> None:
        if not self.done:
            self._score = score
            self._finish()

    def _fail(self, exc: BaseException) -> None:
        if not self.done:
            self._error = exc
            self._finish()


def bucket_for(t: int, ladder: Sequence[int] = _BUCKET_LADDER) -> int:
    """Smallest bucket boundary >= t (doubling past the ladder's end)."""
    for b in ladder:
        if t <= b:
            return b
    b = ladder[-1]
    while b < t:
        b *= 2
    return b


class MicroBatcher:
    """Shape-bucketed micro-batching over ``Engine.score_masked``."""

    def __init__(
        self,
        engine: Engine,
        *,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        max_queue: int = 1024,
        max_seq_len: Optional[int] = None,
        telemetry: Optional[Telemetry] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_seq_len is None:
            max_seq_len = _BUCKET_LADDER[-1]
        if max_seq_len < 1:
            raise ValueError(f"max_seq_len must be >= 1, got {max_seq_len}")
        self.engine = engine
        self.features = engine.cfg.lstm_ae.input_features
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.max_seq_len = max_seq_len
        self.telemetry = telemetry or Telemetry()
        self._clock = clock
        # the fixed lane count pads max_batch up to a per-device multiple
        # (max_batch itself under the single placement, the only one here)
        self.placement = engine.placement
        self.lanes = self.placement.pad_rows(max_batch)
        # bucket_T -> FIFO of (series (T,F) float32, ticket)
        self._buckets: dict[int, list[tuple[np.ndarray, Ticket]]] = {}
        self._depth = 0
        # bucket_T -> persistent (x, lengths) pad buffers: each bucket's
        # fixed (lanes, tb, F) assembly target is allocated once and
        # reused every flush, so assembling a batch is one copy per
        # window with zero allocation on the hot path.  Safe to reuse
        # because every flush has finished reading its buffer before the
        # next one writes it: Engine.score_masked moves the buffer to the
        # GPU with a pageable, blocking host-to-device copy (eagerly
        # torch's as_tensor(..., device=...); captured, the copy_ into the
        # program's static input), which returns only once the host
        # buffer may be reused — on the CPU the engine reads it in place,
        # synchronously — and the scores' .cpu() ends the flush besides.
        # A pinned buffer copied with non_blocking=True would race.
        # Each (lanes, bucket_T, F) is one captured program on a capturing
        # engine.  Its replay is not re-entrant (one static input per
        # shape): the engine's graph cache runs one call at a time, and
        # the socket transport (gateway/server.py) runs every flush and
        # pool step of a gateway on its event loop's one thread.
        self._pad: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def queue_depth(self) -> int:
        return self._depth

    # -- control-plane actuation ------------------------------------------

    def set_knobs(
        self,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
    ) -> dict:
        """Adjust the batching knobs at runtime; returns the applied values.

        ``max_batch`` is clamped to ``[1, lanes]`` — the lane count (and
        with it every (lanes, bucket_T, F) shape) was fixed at
        construction, so a controller can move the flush trigger freely
        without ever minting a new shape.  ``max_wait_ms`` is
        continuous and unconstrained (floored at 0).  Buckets already
        fuller than a lowered ``max_batch`` drain on the next pump.
        """
        if max_batch is not None:
            self.max_batch = min(max(1, int(max_batch)), self.lanes)
        if max_wait_ms is not None:
            self.max_wait_ms = max(0.0, float(max_wait_ms))
        return {"max_batch": self.max_batch, "max_wait_ms": self.max_wait_ms}

    # -- intake -----------------------------------------------------------

    def submit(self, series) -> Ticket:
        """Enqueue one (T, F) window for scoring; returns its ticket.

        Raises :class:`GatewayOverloadedError` when ``max_queue`` requests
        are already pending (backpressure) and ValueError on shape
        mismatch or when the window is longer than ``max_seq_len`` (the
        admission limit that keeps the bucket ladder — and therefore the
        set of shapes — bounded).  A bucket reaching ``max_batch``
        flushes immediately.
        """
        arr = np.asarray(series, np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.features:
            raise ValueError(
                f"expected a (T, {self.features}) window, got shape {arr.shape}"
            )
        if arr.shape[0] < 1:
            raise ValueError("empty window (T == 0)")
        if arr.shape[0] > self.max_seq_len:
            raise ValueError(
                f"window length {arr.shape[0]} exceeds max_seq_len="
                f"{self.max_seq_len}; longer windows would mint a fresh "
                f"bucket shape per power of two (raise max_seq_len to admit)"
            )
        if self._depth >= self.max_queue:
            self.telemetry.count("queue.rejected")
            raise GatewayOverloadedError(
                f"queue full ({self.max_queue} pending); pump() or shed load"
            )
        ticket = Ticket(self._clock())
        tb = bucket_for(arr.shape[0])
        self._buckets.setdefault(tb, []).append((arr, ticket))
        self._depth += 1
        self.telemetry.count("queue.submitted")
        self.telemetry.gauge("queue.depth", self._depth)
        if len(self._buckets[tb]) >= self.max_batch:
            self._flush_bucket(tb)
        return ticket

    # -- flushing ---------------------------------------------------------

    def pump(self, now: Optional[float] = None) -> int:
        """Flush every bucket that is full or whose oldest request has
        waited ``max_wait_ms``; returns the number of requests completed.
        The serve loop calls this between I/O events."""
        now = self._clock() if now is None else now
        completed = 0
        for tb in list(self._buckets):
            pending = self._buckets.get(tb)
            if not pending:
                continue
            waited_ms = (now - pending[0][1].t_submit) * 1e3
            if len(pending) >= self.max_batch or waited_ms >= self.max_wait_ms:
                completed += self._flush_bucket(tb)
        return completed

    def flush(self) -> int:
        """Flush everything pending regardless of age; returns count."""
        completed = 0
        for tb in list(self._buckets):
            while self._buckets.get(tb):
                completed += self._flush_bucket(tb)
        return completed

    def _flush_bucket(self, tb: int) -> int:
        """Flush up to ``max_batch`` requests from bucket ``tb``; returns the
        number *successfully scored*.  The taken requests leave the queue
        unconditionally — an engine failure mid-flush fails their tickets
        (error state + ``queue.failed``) instead of leaking queue depth and
        leaving them unresolved forever (the overload-wedge bug)."""
        pending = self._buckets[tb]
        take, self._buckets[tb] = pending[: self.max_batch], pending[self.max_batch:]
        if not take:
            return 0
        n = len(take)
        # the take is out of the queue from here on, success or failure
        self._depth -= n
        self.telemetry.gauge("queue.depth", self._depth)
        t_flush = self._clock()
        try:
            # fixed (lanes, tb, F) shape per bucket
            # (lanes == max_batch rounded to a per-device multiple)
            pad = self._pad.get(tb)
            if pad is None:
                pad = self._pad[tb] = (
                    np.zeros((self.lanes, tb, self.features), np.float32),
                    np.ones((self.lanes,), np.int32),
                )
            x, lengths = pad
            for i, (arr, _) in enumerate(take):
                ti = arr.shape[0]
                x[i, :ti] = arr
                # zero only the tail this row exposes — rows >= n keep a
                # previous flush's data but their lengths are reset to 1
                # below, so they are padding lanes and masked regardless
                x[i, ti:] = 0.0
                lengths[i] = ti
            lengths[n:] = 1
            t_assembled = self._clock()
            scores = self.engine.score_masked(
                {"series": x, "lengths": lengths}).cpu().numpy()
        except Exception as exc:
            self.telemetry.count("queue.failed", n)
            for _, ticket in take:
                ticket._fail(exc)
            return 0
        now = self._clock()
        assemble_ms = (t_assembled - t_flush) * 1e3
        compute_ms = (now - t_assembled) * 1e3
        oldest_wait_ms = (now - take[0][1].t_submit) * 1e3
        tel = self.telemetry
        tel.observe_stage("assemble_ms", assemble_ms)
        tel.observe_stage("compute_ms", compute_ms)
        # per-ticket stage records resolve their histograms once per
        # flush, not once per ticket — this loop is the score hot path
        wait_hist = tel.histograms.get("queue_wait_ms") if tel.detail else None
        if tel.detail and wait_hist is None:
            wait_hist = tel.histograms["queue_wait_ms"] = Histogram()
        req_record = tel.request_histogram.record
        for i, (_, ticket) in enumerate(take):
            queue_wait_ms = (t_flush - ticket.t_submit) * 1e3
            ticket.stage_ms = {
                "queue_wait": queue_wait_ms,
                "assemble": assemble_ms,
                "compute": compute_ms,
            }
            if wait_hist is not None:
                wait_hist.record(queue_wait_ms)
            req_record((now - ticket.t_submit) * 1e3)
            ticket._resolve(float(scores[i]))
        tel.count("queue.completed", n)
        tel.record_batch(n, self.lanes, oldest_wait_ms)
        return n

    # -- convenience ------------------------------------------------------

    def score(self, windows: Sequence) -> np.ndarray:
        """Submit + flush a list of (T, F) windows synchronously; returns
        their scores in submission order (flushing mid-way under
        backpressure instead of failing)."""
        tickets = []
        for w in windows:
            try:
                tickets.append(self.submit(w))
            except GatewayOverloadedError:
                self.flush()
                tickets.append(self.submit(w))
        self.flush()
        return np.array([t.score for t in tickets], np.float32)
