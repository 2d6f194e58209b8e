"""Durable sessions: snapshot/restore for pool streams + token resumption.

Counterpart of ``repro/gateway/durability.py``, over the port's pool,
tokens and checkpoint manager.  Without it a dropped connection's stream
is gone; with it a recovered trajectory must equal the no-failure
trajectory.  The store's layout, snapshot keys (``pool/state{i}``,
``pool/sq_sum``, ``pool/steps``, ``parked/{sid}/...``), leaf order (every
c leaf, then every h leaf) and tokens are the reference's, so a session
snapshotted by one package resumes in the other.

Three pieces:

* :class:`SessionStore` — one on-disk store shared by every worker of a
  front.  Each worker writes periodic snapshots of its ENTIRE pool slot
  block (stacked per-layer ``(h, c)`` rows + running error sums + steps,
  plus per-session metadata: durable id, seq position, recalibration
  epoch) into its own shard subdirectory through the atomic
  ``checkpoint/manager.py`` path.  Snapshots read a host copy and
  serialize on a background thread — the pool step is never
  blocked, and a pump tick that finds the writer busy SKIPS instead of
  waiting.  Restores scan ALL shards, so any worker can revive any
  worker's streams.
* :class:`DurableSessions` — the per-gateway coordinator: mints durable
  session ids, tracks seq positions, parks exact state on graceful
  disconnects, snapshots on a cadence from the server pump, performs the
  drain-time handoff snapshot, and serves ``resume`` (park fast path,
  else cross-shard snapshot lookup + :meth:`SessionPool.restore`).
* signed resumption tokens (:mod:`repro_torch.gateway.tokens`) — every
  ``step`` response carries one; presenting it to ANY worker of the
  front proves ownership and names the session to revive.

Loss semantics: a parked/handed-off
session resumes EXACTLY where it stopped (zero replay); a SIGKILLed
worker's sessions resume from the latest snapshot, and the client
replays its buffered steps since that snapshot — bit-equal to an
uninterrupted run because the masked step is deterministic.  Steps that
are neither snapshotted nor inside the client's replay window are lost;
choose ``snapshot_interval_ms`` ≤ the client's replay-window span.
"""
from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.manager import AsyncCheckpointer, latest_checkpoint
from repro_torch.gateway.tokens import (
    SessionClaim,
    TokenError,
    TokenSigner,
    UnknownSessionError,
    load_or_create_secret,
)

DEFAULT_SHARD = "worker-0"


@dataclass
class SessionRecord:
    """One session's restorable state, as read from a snapshot or parked
    in memory: per-leaf state rows (tree-leaves order), error counters,
    and the seq position the state corresponds to."""

    rows: list
    sq_sum: float
    steps: int
    seq: int
    epoch: int = 0
    parked_at: float = field(default=0.0)


class SessionActiveError(TokenError):
    """Resume refused: the session is currently being served (a token is
    a bearer credential for a DISCONNECTED stream, not a way to fork a
    live one)."""


class SessionStore:
    """Disk layout::

        <directory>/token.secret          shared HMAC secret (0600)
        <directory>/shards/<shard>/step_00000007/{leaves.npz, meta.json}

    Writes go through :class:`AsyncCheckpointer` (atomic tmp+rename,
    background thread, keep-N GC); reads scan every shard's latest
    snapshot.  Snapshot ids continue across respawns so a reborn worker
    never overwrites its predecessor's latest snapshot."""

    def __init__(self, directory: str | Path, *, shard: str = DEFAULT_SHARD,
                 keep: int = 2, token_ttl_s: Optional[float] = 3600.0,
                 clock: Callable[[], float] = time.time):
        self.directory = Path(directory)
        self.shard = shard
        self.shards_root = self.directory / "shards"
        self.shard_dir = self.shards_root / shard
        self.shard_dir.mkdir(parents=True, exist_ok=True)
        self.signer = TokenSigner(
            load_or_create_secret(self.directory), ttl_s=token_ttl_s, clock=clock
        )
        self._ckpt = AsyncCheckpointer(self.shard_dir, keep=keep)
        last = latest_checkpoint(self.shard_dir)
        self._next_id = 0 if last is None else int(last.name.split("_")[1]) + 1

    # -- writes ------------------------------------------------------------

    @property
    def busy(self) -> bool:
        return self._ckpt.busy

    def write(self, flat: dict, meta: dict, *, wait: bool = False) -> dict:
        """Persist one snapshot (``flat``: {key: host ndarray}) through the
        atomic checkpoint path.  ``wait=False`` returns after the host-side
        handoff; serialization runs on the checkpointer's thread."""
        snapshot_id = self._next_id
        self._next_id += 1
        self._ckpt.save(snapshot_id, flat, extra_meta=meta)
        if wait:
            self._ckpt.wait()
        nbytes = int(sum(np.asarray(v).nbytes for v in flat.values()))
        return {"snapshot_id": snapshot_id, "bytes": nbytes}

    def wait(self) -> None:
        self._ckpt.wait()

    @property
    def last_write_ms(self) -> Optional[float]:
        """Serialise-and-rename time of the last completed write, timed on
        the checkpointer's thread."""
        return self._ckpt.last_write_ms

    # -- reads -------------------------------------------------------------

    @staticmethod
    def _read_meta(path: Path) -> Optional[dict]:
        try:
            return json.loads((path / "meta.json").read_text())
        except (OSError, ValueError):
            return None

    @staticmethod
    def _record_from(path: Path, sid: str, entry: dict,
                     meta: dict) -> Optional[SessionRecord]:
        n = int(meta.get("num_state_leaves", 0))
        try:
            with np.load(path / "leaves.npz") as data:
                if entry.get("kind") == "parked":
                    rows = [data[f"parked/{sid}/state{i}"] for i in range(n)]
                    sq = float(data[f"parked/{sid}/sq"])
                    steps = int(data[f"parked/{sid}/steps"])
                else:
                    slot = int(entry["slot"])
                    rows = [data[f"pool/state{i}"][slot] for i in range(n)]
                    sq = float(data["pool/sq_sum"][slot])
                    steps = int(data["pool/steps"][slot])
        except (OSError, KeyError, ValueError):
            return None
        return SessionRecord(rows=rows, sq_sum=sq, steps=steps,
                             seq=int(entry.get("seq", 0)),
                             epoch=int(entry.get("epoch", 0)))

    def lookup(self, sid: str) -> Optional[SessionRecord]:
        """The freshest restorable state for ``sid`` across ALL shards
        (highest seq wins — after a migration several shards may carry
        stale copies).  None when no reachable snapshot knows the id."""
        best = None
        if self.shards_root.exists():
            for shard_dir in sorted(self.shards_root.iterdir()):
                path = latest_checkpoint(shard_dir)
                if path is None:
                    continue
                meta = self._read_meta(path)
                if meta is None:
                    continue
                entry = meta.get("sessions", {}).get(sid)
                if entry is None:
                    continue
                if best is None or int(entry.get("seq", 0)) > best[0]:
                    best = (int(entry.get("seq", 0)), path, entry, meta)
        if best is None:
            return None
        _, path, entry, meta = best
        return self._record_from(path, sid, entry, meta)

    def adopt_shard(self) -> dict[str, SessionRecord]:
        """Everything the PREVIOUS incarnation of this shard's worker had
        snapshotted — called at worker boot so a respawn keeps carrying
        the crashed worker's sessions forward in its own new snapshots
        (otherwise keep-N GC would age them out)."""
        path = latest_checkpoint(self.shard_dir)
        if path is None:
            return {}
        meta = self._read_meta(path)
        if meta is None:
            return {}
        out = {}
        for sid, entry in meta.get("sessions", {}).items():
            rec = self._record_from(path, sid, entry, meta)
            if rec is not None:
                out[sid] = rec
        return out


class DurableSessions:
    """Per-gateway durability coordinator (attach via
    :func:`enable_durability`; the transport reads ``gateway.durability``).

    All methods run on the gateway's single serving thread (the server
    event loop), the thread that runs every pool step: seq bookkeeping
    needs no locks, the pool's rows are never read or written while a
    step runs, and the only blocking work — the device-to-host block
    copy, one copy per leaf — is bounded by pool size, not by disk.  The
    write runs on the checkpointer's thread, which never touches the
    device."""

    def __init__(self, gateway, store: SessionStore, *,
                 snapshot_interval_ms: float = 1000.0,
                 park_ttl_s: float = 900.0,
                 clock: Callable[[], float] = time.monotonic):
        self.gateway = gateway
        self.store = store
        self.interval_s = snapshot_interval_ms / 1e3
        self.park_ttl_s = park_ttl_s
        self._clock = clock
        self.epoch = 0  # bumped by AnomalyGateway.recalibrate
        self.token_refresh_steps = 16  # re-mint cadence (see _mint)
        self._seq: dict[str, int] = {}       # live durable sessions -> seq
        self._tok_cache: dict[str, tuple[int, str]] = {}  # sid -> (epoch, tok)
        self._parked: dict[str, SessionRecord] = {}
        self._snapshots = 0
        self._resumes = 0
        self._replayed_from_park = 0
        self._last_snapshot_t: Optional[float] = None
        self._last_bytes = 0
        self._last_sessions = 0
        self._was_empty = False
        self.last_handoff: Optional[dict] = None
        # a respawned worker rises with its predecessor's sessions parked
        for sid, rec in store.adopt_shard().items():
            rec.parked_at = self._clock()
            self._parked[sid] = rec
        if self._parked:
            gateway.telemetry.count("durability.adopted", len(self._parked))
            gateway.events.emit("adopt", shard=store.shard,
                                sessions=len(self._parked))
        gateway.telemetry.gauge(
            "durability.snapshot_interval_ms", snapshot_interval_ms
        )

    # -- session lifecycle -------------------------------------------------

    def new_session_id(self) -> str:
        return f"s-{uuid.uuid4().hex[:16]}"

    def _mint(self, sid: str, seq: int) -> str:
        """Issue-and-cache a token for ``sid``.  A token's embedded seq
        is informational — ``resume`` restores position from the
        snapshot and the client replays from its own buffer — so steps
        in between refreshes hand out the cached token instead of paying
        json+HMAC on every response."""
        tok = self.store.signer.issue(sid, seq, self.epoch)
        self._tok_cache[sid] = (self.epoch, tok)
        return tok

    def admit(self) -> tuple[str, str]:
        """Admit a fresh durable stream; returns ``(sid, token)``."""
        sid = self.new_session_id()
        self.gateway.admit(sid)
        self._seq[sid] = 0
        self.gateway.telemetry.count("durability.admitted")
        return sid, self._mint(sid, 0)

    def step(self, sid: str, x) -> tuple[float, int, str]:
        """One pool step for ``sid``; returns ``(running_error, seq,
        token)``.  The token is re-minted every ``token_refresh_steps``
        steps (and on epoch change); in between the previous one is
        returned — equally resumable, since replay position comes from
        the client's buffer, not the token."""
        running = self.gateway.step({sid: x})[sid]
        seq = self._seq[sid] = self._seq.get(sid, 0) + 1
        cached = self._tok_cache.get(sid)
        if cached is not None and cached[0] == self.epoch \
                and seq % self.token_refresh_steps:
            return running, seq, cached[1]
        return running, seq, self._mint(sid, seq)

    def close(self, sid: str) -> float:
        """Explicit close: evict AND forget — the session leaves the next
        snapshot, so once old snapshots age out its tokens answer
        ``UnknownSessionError``."""
        final = self.gateway.evict(sid)
        self._seq.pop(sid, None)
        self._tok_cache.pop(sid, None)
        self._parked.pop(sid, None)
        return final

    def suspend(self, sid: str) -> None:
        """Abrupt disconnect: park the EXACT current state host-side and
        free the slot.  A later resume (any worker after the next
        snapshot; this worker immediately) continues with zero loss."""
        if sid not in self._seq:
            return
        try:
            rows, sq, steps = self.gateway.pool.export_slot(sid)
        except KeyError:
            self._seq.pop(sid, None)
            return
        self.gateway.evict(sid)
        self._tok_cache.pop(sid, None)
        self._parked[sid] = SessionRecord(
            rows=rows, sq_sum=sq, steps=steps, seq=self._seq.pop(sid, 0),
            epoch=self.epoch, parked_at=self._clock(),
        )
        self.gateway.telemetry.count("durability.parked")

    def resume(self, token: str) -> dict:
        """Verify ``token`` and revive its session into this worker's
        pool.  Raises TamperedTokenError / ExpiredTokenError /
        UnknownSessionError / SessionActiveError (the class name is the
        wire error code)."""
        claim: SessionClaim = self.store.signer.verify(token)
        sid = claim.sid
        if sid in self._seq:
            raise SessionActiveError(
                f"session {sid!r} is still being served on this worker; "
                f"close or drop its connection before resuming"
            )
        # the locally parked copy is usually freshest (exact state at
        # disconnect), but an ADOPTED park can be stale: the predecessor
        # snapshotted it parked, the session then lived on (and was
        # re-snapshotted by) ANOTHER worker.  Always check the store and
        # take whichever copy is further along.
        rec = self._parked.pop(sid, None)
        disk = self.store.lookup(sid)
        if disk is not None and (rec is None or disk.seq > rec.seq):
            rec = disk
        elif rec is not None:
            self._replayed_from_park += 1
        if rec is None:
            raise UnknownSessionError(
                f"session {sid!r} exists in no reachable snapshot "
                f"(closed, never durable, or aged out of the store)"
            )
        self.gateway.pool.restore(sid, rec.rows, rec.sq_sum, rec.steps)
        self._seq[sid] = rec.seq
        running = float(self.gateway.pool.error_of(sid))
        self._resumes += 1
        self.gateway.telemetry.count("durability.resumed")
        self.gateway.events.emit("resume", sid=sid, seq=rec.seq,
                                 shard=self.store.shard)
        return {
            "sid": sid,
            "seq": rec.seq,
            "running_error": running,
            "token": self._mint(sid, rec.seq),
        }

    # -- snapshotting ------------------------------------------------------

    def _expire_parked(self, now: float) -> None:
        dead = [sid for sid, rec in self._parked.items()
                if now - rec.parked_at > self.park_ttl_s]
        for sid in dead:
            del self._parked[sid]
        if dead:
            self.gateway.telemetry.count("durability.park_expired", len(dead))

    def snapshot_now(self, *, wait: bool = False) -> dict:
        """One full snapshot: the pool block (host copy), live-session
        metadata, and every parked session's rows.  The write itself is
        async unless ``wait``."""
        pool = self.gateway.pool
        t0 = time.perf_counter()
        leaves, sq_sum, steps = pool.export_block()
        t_copied = time.perf_counter()
        flat = {"pool/sq_sum": sq_sum, "pool/steps": steps}
        for i, leaf in enumerate(leaves):
            flat[f"pool/state{i}"] = leaf
        sessions: dict[str, dict] = {}
        for sid, seq in self._seq.items():
            sessions[sid] = {"kind": "live", "slot": pool.slot_of(sid),
                             "seq": seq, "epoch": self.epoch}
        for sid, rec in self._parked.items():
            for i, row in enumerate(rec.rows):
                flat[f"parked/{sid}/state{i}"] = np.asarray(row)
            flat[f"parked/{sid}/sq"] = np.float32(rec.sq_sum)
            flat[f"parked/{sid}/steps"] = np.int32(rec.steps)
            sessions[sid] = {"kind": "parked", "seq": rec.seq,
                             "epoch": rec.epoch}
        meta = {
            "sessions": sessions,
            "num_state_leaves": len(leaves),
            "epoch": self.epoch,
            "shard": self.store.shard,
        }
        out = self.store.write(flat, meta, wait=wait)
        self._snapshots += 1
        self._last_snapshot_t = self._clock()
        self._last_bytes = out["bytes"]
        self._last_sessions = len(sessions)
        self._was_empty = not sessions
        t = self.gateway.telemetry
        # the block's device-to-host copy on this (the loop's) thread
        t.gauge("durability.snapshot_copy_ms", (t_copied - t0) * 1e3)
        self._publish_write_ms()
        t.count("durability.snapshots")
        t.gauge("durability.snapshot_bytes", out["bytes"])
        t.gauge("durability.snapshot_sessions", len(sessions))
        t.gauge("durability.snapshot_age_s", 0.0)
        self.gateway.events.emit(
            "snapshot", shard=self.store.shard,
            snapshot_id=out["snapshot_id"], sessions=len(sessions),
            bytes=out["bytes"],
        )
        return {"sessions": len(sessions), **out}

    def _publish_write_ms(self) -> None:
        """The last completed write's time (the checkpointer's thread's
        clock): this snapshot's when it was waited for, else the one before
        it until a later tick sees it done."""
        ms = self.store.last_write_ms
        if ms is not None:
            self.gateway.telemetry.gauge("durability.snapshot_write_ms", ms)

    def maybe_snapshot(self, now: Optional[float] = None) -> bool:
        """Cadence tick, called from the server's background pump.  Skips
        (never blocks) while the previous write is in flight; skips
        back-to-back empty snapshots so an idle worker stops writing."""
        now = self._clock() if now is None else now
        if not self.store.busy:
            self._publish_write_ms()
        self._expire_parked(now)
        if self._last_snapshot_t is not None:
            age = now - self._last_snapshot_t
            self.gateway.telemetry.gauge("durability.snapshot_age_s", age)
            if age < self.interval_s:
                return False
        if self.store.busy:
            self.gateway.telemetry.count("durability.snapshot_skipped")
            return False
        if self._was_empty and not self._seq and not self._parked:
            return False
        self.snapshot_now()
        return True

    def handoff(self) -> dict:
        """Drain-time migration: ONE synchronous snapshot carrying every
        resident durable session, taken before the transport evicts them.
        Returns ``{"sessions_migrated": <live residents>, ...}`` — the
        number the front's drain summary must equal."""
        migrated = len(self._seq)
        out = self.snapshot_now(wait=True)
        self.last_handoff = {
            "sessions_migrated": migrated,
            "parked_carried": len(self._parked),
            **out,
        }
        self.gateway.telemetry.count("durability.migrated", migrated)
        self.gateway.events.emit(
            "migration", shard=self.store.shard,
            sessions_migrated=migrated, parked_carried=len(self._parked),
        )
        return self.last_handoff

    # -- observability -----------------------------------------------------

    def describe(self) -> dict:
        age = (None if self._last_snapshot_t is None
               else self._clock() - self._last_snapshot_t)
        return {
            "store": str(self.store.directory),
            "shard": self.store.shard,
            "snapshot_interval_ms": self.interval_s * 1e3,
            "snapshots": self._snapshots,
            "snapshot_age_s": age,
            "snapshot_bytes": self._last_bytes,
            "snapshot_sessions": self._last_sessions,
            "durable_live": len(self._seq),
            "parked": len(self._parked),
            "resumes": self._resumes,
            "epoch": self.epoch,
        }


def enable_durability(
    gateway,
    directory: str | Path,
    *,
    shard: str = DEFAULT_SHARD,
    snapshot_interval_ms: float = 1000.0,
    park_ttl_s: float = 900.0,
    token_ttl_s: Optional[float] = 3600.0,
    keep: int = 2,
) -> DurableSessions:
    """Attach a :class:`DurableSessions` coordinator to ``gateway`` (sets
    ``gateway.durability``; the transport and stats pick it up from
    there).  One call per worker, each with its own ``shard`` name over
    one shared ``directory``."""
    store = SessionStore(directory, shard=shard, keep=keep,
                         token_ttl_s=token_ttl_s)
    dur = DurableSessions(
        gateway, store, snapshot_interval_ms=snapshot_interval_ms,
        park_ttl_s=park_ttl_s,
    )
    gateway.durability = dur
    return dur


__all__ = [
    "DurableSessions",
    "SessionActiveError",
    "SessionRecord",
    "SessionStore",
    "enable_durability",
]
