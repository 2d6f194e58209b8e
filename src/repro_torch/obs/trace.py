"""Per-request spans: named stages decomposing end-to-end latency.

Two tracers.  :class:`Span` and :class:`Tracer` are a copy of
``repro/obs/trace.py``, which imports no JAX (the port imports nothing of
``repro``, and ``tests/test_torch_obs.py`` holds the copy to the original):
the socket path's stages, below.  :data:`PROGRAM` is the port's own: nested
spans inside the scoring path (service, engine, captured graph), last in this
file.

A :class:`Tracer` (injectable clock, like ``Telemetry``) produces
:class:`Span` objects.  A span accumulates named stage durations two
ways:

* :meth:`Span.mark` — close the time since the previous mark as a named
  stage (the server's dispatch path uses this for inline stages);
* :meth:`Span.stage` — add an externally measured duration (the
  micro-batcher stamps ``queue_wait``/``assemble``/``compute`` per
  ticket at flush time, which the server folds into the request's span).

Trace ids travel as an optional ``"trace"`` field on wire requests;
both sides' dict-based dispatch ignores unknown fields, so PR 3 clients
and servers interoperate unchanged.  Traced responses carry
``{"trace": {"id", "stages", "total_ms"}}`` back, and the client adds
its own ``serialize`` stage plus the ``wire`` remainder (end-to-end
minus everything attributed), giving a span whose stages sum to the
observed wire latency.

Finished spans are sampled into the JSONL event log (``kind: "span"``)
at a deterministic 1-in-``sample_every`` cadence — no RNG, so tests and
replays see identical sampling decisions.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Callable, Iterator, Optional

from repro_torch.obs.events import EventLog
from repro_torch.obs.histogram import Histogram


class Span:
    """One request's named-stage timing breakdown (durations in ms)."""

    __slots__ = ("name", "trace_id", "t0", "_last", "_clock", "stages",
                 "total_ms")

    def __init__(self, name: str, trace_id: str,
                 clock: Callable[[], float]):
        self.name = name
        self.trace_id = trace_id
        self._clock = clock
        self.t0 = clock()
        self._last = self.t0
        self.stages: dict[str, float] = {}
        self.total_ms: Optional[float] = None

    def mark(self, stage: str) -> float:
        """Close the interval since the previous mark (or span start) as
        ``stage``; returns the interval in ms."""
        now = self._clock()
        ms = (now - self._last) * 1e3
        self.stages[stage] = self.stages.get(stage, 0.0) + ms
        self._last = now
        return ms

    def stage(self, name: str, ms: float) -> None:
        """Attribute an externally measured duration to ``name``."""
        self.stages[name] = self.stages.get(name, 0.0) + float(ms)

    def end(self) -> "Span":
        if self.total_ms is None:
            self.total_ms = (self._clock() - self.t0) * 1e3
        return self

    def to_wire(self) -> dict:
        """The response-payload view (id + stages + server total)."""
        self.end()
        return {
            "id": self.trace_id,
            "stages": {k: round(v, 6) for k, v in self.stages.items()},
            "total_ms": round(self.total_ms, 6),
        }

    def to_dict(self) -> dict:
        d = self.to_wire()
        d["name"] = self.name
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name}, trace={self.trace_id}, "
                f"stages={sorted(self.stages)})")


class Tracer:
    """Span factory with deterministic sampling into an event log."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        events: Optional[EventLog] = None,
        sample_every: int = 1,
    ):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self._clock = clock
        self.events = events
        self.sample_every = sample_every
        self._seq = itertools.count()
        self._finished = 0
        self._emitted = 0
        # pid cached at construction: new_id() sits on the traced hot
        # path and os.getpid() is a syscall per call; workers build their
        # tracer post-spawn so the cached pid is the serving process's
        self._id_prefix = f"t{os.getpid():x}-"

    def new_id(self) -> str:
        """Process-unique trace id (pid-prefixed monotonic counter)."""
        return f"{self._id_prefix}{next(self._seq):x}"

    def start(self, name: str, trace_id: Optional[str] = None) -> Span:
        return Span(name, trace_id or self.new_id(), self._clock)

    def finish(self, span: Span) -> Span:
        """End a span and emit it to the event log on the sampling
        cadence (every ``sample_every``-th finished span)."""
        span.end()
        self._finished += 1
        if self.events is not None and self.events.enabled \
                and (self._finished - 1) % self.sample_every == 0:
            self._emitted += 1
            self.events.emit("span", **span.to_dict())
        return span

    def describe(self) -> dict:
        return {
            "finished": self._finished,
            "emitted": self._emitted,
            "sample_every": self.sample_every,
        }


# -- the program's own spans ---------------------------------------------
#
# The port's scoring path opens a span at each layer boundary it crosses:
#
#   repro_torch.service.score       AnomalyService.score, the root of a request
#   repro_torch.engine.lookup       host arguments, signature, cache lookup
#   repro_torch.engine.capture      a first call at a signature (warm-up, capture)
#   repro_torch.engine.eager        an eager call (the CPU, or jit=False)
#   repro_torch.capture.copy_in     the arguments into a graph's static inputs
#   repro_torch.capture.replay      the graph's launch
#   repro_torch.capture.clone_out   the graph's outputs cloned for the caller
#
# A site costs one flag test and one profiler test while neither a recording
# nor a profiler session is on (``PROGRAM.live()``), and then runs bare.  The
# program a span ran (``score``, ``mstep``, ``score@shard0``, ...) is an
# attribute of it, never part of its name, so readers aggregate by stage.


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is running: torch's own flag, read
    without importing torch (where torch is not loaded, none can run)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def memory_kind(t) -> str:
    """Where a copy reads tensor ``t`` from: "pinned" or "pageable" host
    memory, or "device" (already on a device)."""
    if t.device.type != "cpu":
        return "device"
    return "pinned" if t.is_pinned() else "pageable"


class ProgramSpan:
    """One stage of one call: its name, the program it ran, start and end
    (``time.perf_counter_ns``), its depth among the spans open on its thread,
    the span it ran inside, the id of its request (that of the root span, the
    outermost open on its thread) and the time its children covered.  It
    times itself whenever it is entered; the recording that was on when it
    opened keeps it and, when its request ends, gives it its parent, request
    id and children's time; while a profiler session runs it also opens a
    range of its name on the profiler's own clock."""

    __slots__ = ("name", "program", "start_ns", "end_ns", "depth", "parent", "request",
                 "child_ns", "_tracer", "_rec", "_range")

    def __init__(self, tracer: "ProgramTracer", name: str, program: Optional[str] = None):
        self.name = name
        self.program = program
        self.child_ns = 0
        self.parent: Optional[ProgramSpan] = None
        self.request: Optional[str] = None
        self._tracer = tracer
        self._rec: Optional[Recording] = None
        self._range = None

    def __enter__(self) -> "ProgramSpan":
        rec = self._tracer.active
        if rec is not None:           # join the request open on this thread
            self._rec = rec
            t = rec._thread
            self.depth = t.depth
            t.depth += 1
            if len(t.records) < rec.MAX_SPANS:
                t.records.append(self)
            else:
                rec._drop()
        if _profiling():
            # a FUNCTION-scope range: a user annotation (``record_function``)
            # is also projected onto the device's timeline, where a reader of
            # the trace would take the projection for a kernel
            self._range = sys.modules["torch"]._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        rec = self._rec
        if rec is not None:
            t = rec._thread
            t.depth -= 1
            if not t.depth:           # the root: its request ends
                rec._fold(t)
        return False

    @property
    def total_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """Total less what the span's children covered."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    def __repr__(self) -> str:
        parent = self.parent.name if self.parent is not None else None
        return (f"ProgramSpan({self.name}, program={self.program}, request={self.request}, "
                f"parent={parent}, total_ms={self.total_ms:.6f})")


class _ThreadSpans(threading.local):
    """One thread's depth of open spans, its open request's records and the
    tensors it copied in."""

    def __init__(self):
        self.depth = 0
        self.records: list = []
        self.copies: list = []


class Recording:
    """What the program's spans recorded while this recording was on.

    A span opening only takes its depth and joins its request's records (at
    most ``MAX_SPANS``; ``dropped`` counts the rest): all else waits.  When the request's root
    span closes, after the work it launched is under way, the records get
    their parents, request id and children's time and are folded into one
    :class:`Histogram` of total ms and one of self ms per span name, and a
    count of calls per span name; the last ``KEEP`` requests' records stay
    in ``last``.  ``h2d_bytes`` counts the bytes copied into captured
    programs' static inputs, by the source's memory (:func:`memory_kind`),
    also when the request ends: the memory query costs microseconds."""

    KEEP = 64
    MAX_SPANS = 256

    def __init__(self, ids: Tracer):
        self.total_ms: dict[str, Histogram] = {}
        self.self_ms: dict[str, Histogram] = {}
        self.calls: dict[str, int] = {}
        self.requests = 0
        self.h2d_bytes = {"pinned": 0, "pageable": 0, "device": 0}
        self.dropped = 0
        self.last: collections.deque = collections.deque(maxlen=self.KEEP)
        self._ids = ids
        self._thread = _ThreadSpans()
        self._lock = threading.Lock()

    def _drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def _fold(self, t: _ThreadSpans) -> None:
        records, t.records = t.records, []
        # spans on one thread nest: a span's parent is the last one opened
        # before it one level up
        request = self._ids.new_id()
        up: list = []
        for s in records:
            del up[s.depth:]
            if up:
                s.parent = up[-1]
                s.parent.child_ns += s.end_ns - s.start_ns
            s.request = request
            s._rec = None
            up.append(s)
        with self._lock:
            self.requests += 1
            for s in records:
                name = s.name
                if name not in self.calls:
                    self.calls[name] = 0
                    self.total_ms[name] = Histogram()
                    self.self_ms[name] = Histogram()
                self.calls[name] += 1
                self.total_ms[name].record(s.total_ms)
                self.self_ms[name].record(s.self_ms)
            self.last.append(records)
        self._count_copies(t)

    def copied_in(self, tensor) -> None:
        """Count a copy from ``tensor`` into a static input: by its memory
        when the request open on this thread ends (at once outside one)."""
        t = self._thread
        t.copies.append(tensor)
        if not t.depth:
            self._count_copies(t)

    def _count_copies(self, t: _ThreadSpans) -> None:
        copies, t.copies = t.copies, []
        counted = [(memory_kind(c), c.numel() * c.element_size()) for c in copies]
        with self._lock:
            for memory, nbytes in counted:
                self.h2d_bytes[memory] += nbytes

    def describe(self) -> dict:
        """Per span name its calls, calls a request and the median (nearest
        rank, to the histogram's bucket) and mean of its total and self ms;
        the requests, the bytes copied in and the records dropped."""
        with self._lock:
            n = max(1, self.requests)
            spans = {name: {"calls": calls, "calls_per_request": calls / n,
                            "total_ms_p50": self.total_ms[name].percentile(50),
                            "total_ms_mean": self.total_ms[name].mean(),
                            "self_ms_p50": self.self_ms[name].percentile(50),
                            "self_ms_mean": self.self_ms[name].mean()}
                     for name, calls in self.calls.items()}
            return {"requests": self.requests, "spans": spans,
                    "h2d_bytes": dict(self.h2d_bytes), "dropped": self.dropped}


class ProgramTracer:
    """The process's tracer of the port's program (:data:`PROGRAM`): sites
    open spans through :meth:`span` where :meth:`live` says so; a stretch of
    calls is recorded inside ``with PROGRAM.recording() as rec:``."""

    def __init__(self):
        self.active: Optional[Recording] = None
        self._ids = Tracer()

    def live(self) -> bool:
        """Whether a span opened now is recorded or shown to a profiler."""
        return self.active is not None or _profiling()

    def span(self, name: str, program: Optional[str] = None) -> ProgramSpan:
        return ProgramSpan(self, name, program)

    @contextlib.contextmanager
    def recording(self) -> Iterator[Recording]:
        """Record every span opened inside the block, on any thread; the
        recording that was on before is on again after it."""
        rec = Recording(self._ids)
        before, self.active = self.active, rec
        try:
            yield rec
        finally:
            self.active = before


PROGRAM = ProgramTracer()
