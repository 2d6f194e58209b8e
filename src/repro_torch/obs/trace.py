"""Per-request spans: named stages decomposing end-to-end latency.

A copy of ``repro/obs/trace.py``, which imports no JAX: the port imports nothing
of ``repro``, and ``tests/test_torch_obs.py`` holds the copy to the original.

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

import itertools
import os
import time
from typing import Callable, Optional

from repro_torch.obs.events import EventLog


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

    def stage_sum_ms(self) -> float:
        return sum(self.stages.values())

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
