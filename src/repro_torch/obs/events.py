"""Append-only JSONL event log: lifecycle events + sampled spans.

A copy of ``repro/obs/events.py``, which imports no JAX: the port imports nothing
of ``repro``, and ``tests/test_torch_obs.py`` holds the copy to the original.

One :class:`EventLog` per process (each worker writes its own file, so
no cross-process locking is needed).  Every record is one JSON object
per line::

    {"ts": <unix seconds>, "kind": "<event kind>", ...fields}

Kinds emitted by the stack: ``boot``, ``respawn``, ``snapshot``,
``resume``, ``migration``, ``adopt``, ``recalibrate``, ``drain``,
``serve_start``, ``bucket_compile`` and ``span`` (a sampled request
trace — see :mod:`repro_torch.obs.trace` for the span schema).

Constructed with ``path=None`` the log is disabled and every ``emit`` is
a cheap no-op, so call sites never need to branch.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class EventLog:
    """JSONL writer with a wall-clock timestamp per record."""

    def __init__(
        self,
        path: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ):
        self._clock = clock
        self.path = os.fspath(path) if path is not None else None
        self._fh = None
        if self.path is not None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def emit(self, kind: str, **fields) -> None:
        """Append one event; silently drops records once closed/disabled
        (observability must never take the serving path down)."""
        if self._fh is None:
            return
        record = {"ts": round(self._clock(), 6), "kind": str(kind)}
        record.update(fields)
        try:
            self._fh.write(json.dumps(record, default=str) + "\n")
            self._fh.flush()
        except (OSError, ValueError):
            # best-effort sink, but a dead one silently losing every
            # event is worth a (rate-unbounded, debug-only) trace
            logger.debug("event log write failed for %r", self.path,
                         exc_info=True)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None

    def __repr__(self) -> str:
        state = self.path if self.enabled else "disabled"
        return f"EventLog({state})"
