"""Adaptive micro-batching controller: p95-vs-SLO feedback over
``max_batch`` / ``max_wait_ms`` with the latency model as feedforward.

Copy of ``repro/control/batching.py`` (pure Python, no JAX).  The
controller closes the loop from telemetry to knobs: each tick it reads
the gateway's sensors (request p95, batch-fill ratio, queue depth,
windowed arrival rate) and nudges the two batching knobs.  Three design
rules keep it from wrecking the thing it tunes:

* **Feedforward prior** — :func:`repro_torch.core.latency.serving_floor_ms`
  predicts the compute floor for the served bucket shape (the paper's
  Eq-1 model of its FPGA, copied unchanged; on a GPU it is a prior, not
  a measurement), so the
  controller treats ``slo - floor`` as its whole search space (the
  *residual budget*) and never commands a wait that alone blows the SLO.
  An SLO at or under the floor is declared infeasible once instead of
  being chased forever.
* **Hysteresis** — it acts only after ``patience`` consecutive ticks out
  of band (over the SLO, or under ``low_band * slo`` with room to relax)
  and then goes quiet for ``cooldown_ticks``, so one noisy percentile
  sample never flaps the knobs.
* **Bounded actuation** — one knob, one bounded multiplicative step per
  action; ``max_batch`` moves only inside ``[1, lanes]`` where the
  captured (lanes, bucket_T, F) programs already exist, so adaptation
  NEVER causes a new capture (the graph cache is the one thing a latency
  controller must not oscillate).

Pure decision logic — no I/O, no threads; the owning plane applies the
returned knobs and journals the decision.
"""
from __future__ import annotations

from typing import Optional


class BatchingController:
    """One `decide()` per control tick -> hold / shrink_wait / grow_wait /
    grow_batch / shrink_batch, with the reason attached."""

    def __init__(
        self,
        *,
        slo_p95_ms: float,
        floor_ms: float,
        lanes: int,
        min_wait_ms: float = 0.25,
        low_band: float = 0.6,
        wait_budget_frac: float = 0.8,
        step: float = 2.0,
        patience: int = 2,
        cooldown_ticks: int = 2,
        full_fill: float = 0.9,
    ):
        if slo_p95_ms <= 0:
            raise ValueError(f"slo_p95_ms must be > 0, got {slo_p95_ms}")
        self.slo_p95_ms = float(slo_p95_ms)
        self.floor_ms = float(floor_ms)
        self.lanes = int(lanes)
        self.min_wait_ms = float(min_wait_ms)
        self.low_band = float(low_band)
        self.step = float(step)
        self.patience = int(patience)
        self.cooldown_ticks = int(cooldown_ticks)
        self.full_fill = float(full_fill)
        # residual the controller is allowed to spend on queueing/batching
        self.budget_ms = self.slo_p95_ms - self.floor_ms
        self.wait_cap_ms = max(self.min_wait_ms, wait_budget_frac * self.budget_ms)
        self._hot = 0       # consecutive ticks over the SLO
        self._cold = 0      # consecutive ticks far under it
        self._cooldown = 0  # ticks to stay quiet after an action
        self._infeasible_reported = False
        self.actions = 0

    @property
    def feasible(self) -> bool:
        return self.budget_ms > 0.0

    def prior_knobs(self, max_batch: int, max_wait_ms: float) -> dict:
        """Feedforward starting point: spend a quarter of the residual
        budget on batching wait (capped), before any feedback has run."""
        if not self.feasible:
            return {"max_batch": max_batch, "max_wait_ms": 0.0}
        wait = min(self.wait_cap_ms, max(self.min_wait_ms, 0.25 * self.budget_ms))
        return {
            "max_batch": min(max(1, int(max_batch)), self.lanes),
            "max_wait_ms": min(float(max_wait_ms), wait)
            if max_wait_ms else wait,
        }

    def decide(
        self,
        *,
        p95_ms: float,
        fill: float,
        depth: int,
        arrival_rps: float,
        max_batch: int,
        max_wait_ms: float,
    ) -> dict:
        """One control tick.  Returns a decision record::

            {"action", "reason", "knobs" (None when holding),
             "p95_ms", "slo_ms", "fill", "depth", "arrival_rps"}
        """
        obs = {
            "p95_ms": float(p95_ms), "slo_ms": self.slo_p95_ms,
            "fill": float(fill), "depth": int(depth),
            "arrival_rps": float(arrival_rps),
        }

        def out(action: str, reason: str, knobs: Optional[dict] = None) -> dict:
            if knobs is not None:
                self.actions += 1
                self._cooldown = self.cooldown_ticks
                self._hot = self._cold = 0
            return {"action": action, "reason": reason, "knobs": knobs, **obs}

        if not self.feasible:
            # the model says the SLO is unreachable even with zero wait —
            # pin the wait to zero once and say so, don't thrash
            if not self._infeasible_reported:
                self._infeasible_reported = True
                return out(
                    "pin_wait", "slo_infeasible",
                    {"max_wait_ms": 0.0},
                )
            return out("hold", "slo_infeasible")

        if self._cooldown > 0:
            self._cooldown -= 1
            return out("hold", "cooldown")

        if p95_ms > self.slo_p95_ms:
            self._hot += 1
            self._cold = 0
        elif p95_ms < self.low_band * self.slo_p95_ms and p95_ms > 0.0:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
            return out("hold", "in_band")

        if self._hot >= self.patience:
            if fill >= self.full_fill and max_batch < self.lanes:
                # batches already full: throughput-bound, widen the flush
                # (still inside the captured lane count)
                new_batch = min(self.lanes, max(max_batch + 1,
                                                int(max_batch * self.step)))
                return out("grow_batch", "over_slo_batches_full",
                           {"max_batch": new_batch})
            if max_wait_ms > self.min_wait_ms:
                # wait-bound: flush sooner
                new_wait = max(self.min_wait_ms, max_wait_ms / self.step)
                return out("shrink_wait", "over_slo_wait_bound",
                           {"max_wait_ms": new_wait})
            if max_batch > 1 and fill < self.full_fill:
                # nothing left on the wait axis and batches run empty:
                # smaller flush trigger trims residual queueing
                return out("shrink_batch", "over_slo_wait_floored",
                           {"max_batch": max(1, max_batch // 2)})
            return out("hold", "over_slo_saturated")

        if self._cold >= self.patience and max_wait_ms < self.wait_cap_ms:
            # comfortably under the SLO: trade latency headroom for fill
            new_wait = min(self.wait_cap_ms,
                           max(max_wait_ms * self.step, 2 * self.min_wait_ms))
            return out("grow_wait", "under_slo_headroom",
                       {"max_wait_ms": new_wait})

        return out("hold", "waiting_for_patience")

    def describe(self) -> dict:
        return {
            "slo_p95_ms": self.slo_p95_ms,
            "floor_ms": self.floor_ms,
            "budget_ms": self.budget_ms,
            "wait_cap_ms": self.wait_cap_ms,
            "feasible": self.feasible,
            "actions": self.actions,
        }
