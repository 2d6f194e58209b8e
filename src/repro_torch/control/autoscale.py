"""Worker autoscaler: arrival-rate-driven worker count between bounds.

Copy of ``repro/control/autoscale.py`` (pure Python, no JAX).  SHARP's
argument in hardware — an RNN accelerator should adapt its configuration
to the workload instead of shipping one operating point — applied to the
worker fleet: the supervisor already knows how to spawn workers and
drain them with zero-loss snapshot handoff, so worker count is just one
more actuated knob.  :class:`Autoscaler` is the pure
decision half: each tick it compares the windowed arrival rate against
the fleet's estimated service capacity (``workers * worker_rps``, where
``worker_rps`` comes from the latency model or measurement) plus queue
saturation, and votes +1 / 0 / -1 inside ``[min_workers, max_workers]``.

Same discipline as the batching controller: ``patience`` consecutive
out-of-band ticks before any action, a cooldown after each one (worker
spawn has real cost — the captures of the warm-up — so flapping is worse
here), and a bounded step of one worker per action.  Scale-down is decided here but
*executed* by the supervisor as a drain, never a kill.
"""
from __future__ import annotations


class Autoscaler:
    """Utilization-band voter over the worker count."""

    def __init__(
        self,
        *,
        min_workers: int,
        max_workers: int,
        worker_rps: float,
        high_util: float = 0.85,
        low_util: float = 0.35,
        depth_high: float = 0.5,
        patience: int = 2,
        cooldown_ticks: int = 3,
    ):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(
                f"need 1 <= min <= max, got {min_workers}:{max_workers}"
            )
        if worker_rps <= 0:
            raise ValueError(f"worker_rps must be > 0, got {worker_rps}")
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.worker_rps = float(worker_rps)
        self.high_util = float(high_util)
        self.low_util = float(low_util)
        self.depth_high = float(depth_high)
        self.patience = int(patience)
        self.cooldown_ticks = int(cooldown_ticks)
        self._hot = 0
        self._cold = 0
        self._cooldown = 0
        self.actions = 0

    def decide(
        self,
        *,
        arrival_rps: float,
        workers: int,
        queue_depth: int = 0,
        max_queue: int = 1024,
    ) -> dict:
        """One tick -> ``{"delta", "reason", "utilization", ...}`` with
        ``delta`` in {-1, 0, +1} already clamped to the bounds."""
        capacity = max(workers, 1) * self.worker_rps
        util = float(arrival_rps) / capacity
        depth_frac = float(queue_depth) / max(1, workers * max_queue)
        obs = {
            "utilization": util, "depth_frac": depth_frac,
            "arrival_rps": float(arrival_rps), "workers": int(workers),
            "worker_rps": self.worker_rps,
        }

        def out(delta: int, reason: str) -> dict:
            if delta:
                self.actions += 1
                self._cooldown = self.cooldown_ticks
                self._hot = self._cold = 0
            return {"delta": delta, "reason": reason, **obs}

        if workers < self.min_workers:
            return out(+1, "below_min")
        if workers > self.max_workers:
            return out(-1, "above_max")
        if self._cooldown > 0:
            self._cooldown -= 1
            return out(0, "cooldown")

        if util > self.high_util or depth_frac > self.depth_high:
            self._hot += 1
            self._cold = 0
        elif util < self.low_util and depth_frac < 0.1:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
            return out(0, "in_band")

        if self._hot >= self.patience:
            if workers >= self.max_workers:
                return out(0, "saturated_at_max")
            return out(+1, "over_capacity")
        if self._cold >= self.patience:
            if workers <= self.min_workers:
                return out(0, "idle_at_min")
            return out(-1, "under_utilized")
        return out(0, "waiting_for_patience")

    def describe(self) -> dict:
        return {
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "worker_rps": self.worker_rps,
            "high_util": self.high_util,
            "low_util": self.low_util,
            "actions": self.actions,
        }
