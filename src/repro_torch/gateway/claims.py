"""Device-claim registry: the devices of the workers must be DISJOINT.

Copy of ``repro/gateway/claims.py``; a claimed device is a CUDA device,
written ``"cuda:N"`` (an int ``N`` means the same).  Without claims every
worker of a front takes the current CUDA device; nothing would stop two
workers from placing their pool blocks on the same card and silently
halving throughput.  This registry makes disjointness a checked
invariant: each worker writes an atomic claim file naming the devices it
owns, and claiming a device already held by a LIVE other worker fails
loudly, naming the conflicting owner and devices.

Layout: ``<dir>/claims/<owner>.json`` with ``{"owner", "pid", "devices",
"claimed_at"}``.  Claims from dead pids are stale and reaped on the next
conflicting claim — a SIGKILLed worker cannot wedge its replacement.
Framework-free: the supervisor validates before any worker boots.
"""
from __future__ import annotations

import errno
import json
import os
import time
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence


class DeviceClaimError(RuntimeError):
    """Two owners claim the same device(s) — the error message names the
    conflicting owner, its pid, and the overlapping devices."""


def device_name(device) -> str:
    """The canonical name of a claimed device: an int ``N`` is
    ``"cuda:N"``, so mixed int/str specs of one device collide."""
    return f"cuda:{device}" if isinstance(device, int) else str(device)


def claimed_cuda_index(devices: Iterable) -> Optional[int]:
    """The index of the first CUDA device a claim names (the one a worker
    makes current), or None when it names none."""
    for d in devices:
        name = device_name(d)
        if name.startswith("cuda:"):
            return int(name.split(":", 1)[1])
    return None


# the devices this process claimed (a worker registers its claim at boot,
# before its factory runs), so the factory can lay its placement on them
_process_claim: tuple[str, ...] = ()


def set_process_claim(devices: Iterable) -> None:
    """Record the devices this worker process claimed, in claim order."""
    global _process_claim
    _process_claim = tuple(device_name(d) for d in devices)


def process_claim() -> tuple[str, ...]:
    """The devices this process claimed (empty when it claimed none)."""
    return _process_claim


def _norm_devices(devices: Iterable) -> tuple[str, ...]:
    """Canonical device names, sorted; a device listed twice raises."""
    out = [device_name(d) for d in devices]
    if len(set(out)) != len(out):
        raise DeviceClaimError(f"claim lists a device twice: {sorted(out)}")
    return tuple(sorted(out))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM  # alive but not ours
    return True


def validate_disjoint(claims: Mapping[str, Sequence]) -> None:
    """Pure check used by the supervisor BEFORE spawning: every pair of
    owners in ``claims`` must claim disjoint device sets."""
    seen: dict[str, str] = {}
    for owner, devices in claims.items():
        for dev in _norm_devices(devices):
            if dev in seen:
                raise DeviceClaimError(
                    f"device claim overlap: {owner!r} and {seen[dev]!r} "
                    f"both claim {dev}"
                )
            seen[dev] = owner


class DeviceClaimRegistry:
    """File-backed claims under ``<directory>/claims/``."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory) / "claims"
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, owner: str) -> Path:
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in owner)
        return self.directory / f"{safe}.json"

    def claims(self) -> dict[str, dict]:
        out = {}
        for p in sorted(self.directory.glob("*.json")):
            try:
                entry = json.loads(p.read_text())
                out[entry["owner"]] = entry
            except (ValueError, KeyError):
                continue  # torn write of a crashed claimer; rename is atomic
        return out

    def claim(self, owner: str, devices: Sequence, *,
              pid: Optional[int] = None) -> dict:
        """Atomically claim ``devices`` for ``owner``.  Re-claiming by the
        same owner (a respawn) replaces its own entry.  A conflict with a
        live owner raises :class:`DeviceClaimError`; conflicts with dead
        owners reap the stale file and proceed."""
        pid = os.getpid() if pid is None else int(pid)
        devices = _norm_devices(devices)
        for other, entry in self.claims().items():
            if other == owner:
                continue
            overlap = sorted(set(devices) & set(entry.get("devices", ())))
            if not overlap:
                continue
            other_pid = int(entry.get("pid", -1))
            if other_pid > 0 and _pid_alive(other_pid):
                raise DeviceClaimError(
                    f"worker {owner!r} (pid {pid}) cannot claim "
                    f"{', '.join(overlap)}: already claimed by live worker "
                    f"{other!r} (pid {other_pid})"
                )
            self._path(other).unlink(missing_ok=True)  # stale: owner is dead
        entry = {
            "owner": owner,
            "pid": pid,
            "devices": list(devices),
            "claimed_at": time.time(),
        }
        tmp = self._path(owner).with_suffix(".json.tmp")
        tmp.write_text(json.dumps(entry, indent=1))
        os.replace(tmp, self._path(owner))
        return entry

    def release(self, owner: str) -> None:
        self._path(owner).unlink(missing_ok=True)

    def validate(self) -> dict[str, dict]:
        """Re-check every registered claim pair; returns the claim map."""
        entries = self.claims()
        validate_disjoint({o: e.get("devices", ()) for o, e in entries.items()})
        return entries
