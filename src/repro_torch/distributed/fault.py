"""Fault tolerance & straggler mitigation for long-running training.

Copy of ``repro/distributed/fault.py`` on the port's ``checkpoint/``:

* **Heartbeat / straggler detection** — the training loop reports per-step
  wall time per participant; a step slower than ``straggler_factor`` x the
  rolling p50 flags that participant.  At pod scale the launcher maps
  participants to hosts; here the unit tests inject synthetic timings.
* **Deterministic restart** — ``run_with_recovery`` wraps the step loop:
  on failure (a real exception, or an injected ``FailureInjector`` fault)
  it restores the latest checkpoint — including the data-iterator index —
  and continues; the resulting loss trajectory must equal the no-failure
  run (test-asserted), which is the property that matters at 1000+ nodes.
* **Restore target** — each restored leaf lands on the device of the
  matching leaf of ``state_template`` (default: the initial state), so a
  run on the GPU recovers on the GPU.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    restore_checkpoint,
)


@dataclass
class HeartbeatMonitor:
    """Rolling per-participant step-time tracking with p50-based flagging."""
    window: int = 64
    straggler_factor: float = 2.0
    history: dict = field(default_factory=dict)

    def report(self, participant: str, step_time_s: float) -> None:
        self.history.setdefault(participant, deque(maxlen=self.window)).append(step_time_s)

    def p50(self) -> float:
        times = sorted(t for h in self.history.values() for t in h)
        if not times:
            return 0.0
        return times[len(times) // 2]

    def stragglers(self) -> list[str]:
        base = self.p50()
        if base <= 0:
            return []
        out = []
        for who, h in self.history.items():
            if h and h[-1] > self.straggler_factor * base:
                out.append(who)
        return sorted(out)


class FailureInjector:
    """Deterministic fault injection for recovery tests: raises
    ``SimulatedFailure`` at the given step indices (once each)."""

    def __init__(self, fail_at_steps: tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class SimulatedFailure(RuntimeError):
    pass


def run_with_recovery(
    *,
    state,
    train_step: Callable,
    iterator,
    total_steps: int,
    ckpt_dir,
    ckpt_every: int = 10,
    injector: Optional[FailureInjector] = None,
    monitor: Optional[HeartbeatMonitor] = None,
    max_restarts: int = 8,
    state_template=None,
) -> tuple[object, list[float]]:
    """Step loop with checkpoint/restart recovery.

    Returns (final state, per-step losses).  On failure, restores the
    latest checkpoint (state + iterator index) and replays from there —
    losses of replayed steps overwrite the aborted trajectory, giving a
    deterministic final history.
    """
    ckpt = AsyncCheckpointer(ckpt_dir, keep=2)
    losses: dict[int, float] = {}
    step = 0
    restarts = 0
    template = state_template if state_template is not None else state
    # step-0 anchor so pre-first-checkpoint failures restart deterministically
    if latest_checkpoint(ckpt_dir) is None:
        ckpt.save(0, state, extra_meta={"iterator": iterator.state_dict()})
        ckpt.wait()

    while step < total_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.monotonic()
            batch = next(iterator)
            state, metrics = train_step(state, batch)
            dt = time.monotonic() - t0
            if monitor is not None:
                monitor.report("host0", dt)
            losses[step] = float(metrics["loss"])
            step += 1
            if step % ckpt_every == 0:
                ckpt.save(step, state, extra_meta={"iterator": iterator.state_dict()})
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt.wait()
            path = latest_checkpoint(ckpt_dir)
            assert path is not None  # step-0 anchor always exists
            state, meta = restore_checkpoint(path, template)
            iterator.load_state_dict(meta["iterator"])
            step = meta["step"]
    ckpt.wait()
    return state, [losses[i] for i in range(total_steps)]
