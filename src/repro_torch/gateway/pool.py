"""Slot-indexed session pool: thousands of logical streams, one masked step.

Counterpart of ``repro/gateway/pool.py``.  A fixed block of ``capacity``
stream slots — per-layer (h, c) plus running error sums, on the engine's
device — is advanced by one masked step (``Engine.stream_masked``) whatever
streams are resident.  Admission and eviction touch host-side slot maps and
zero the slot's rows in place, so churn costs no new shapes.

The masked step is the engine's plain-PyTorch cell loop, as in the JAX
package, where ``_masked_stream_step`` runs outside any kernel.  The whole
pool step — the masked cell step, the squared errors and the step counts —
is one engine program (``"mstep"``, :meth:`SessionPool._advance`), which
the reference jits as ``_pool_step``; on a capturing engine it is one CUDA
graph per pool, in this pool's own graph cache.  It updates the pool's
block in place, so the block is never a graph's output buffer, and the
rows that admission, eviction and restore write between steps are read by
the next replay.  Churn changes no shape, so it never recaptures.

Semantics contract (held to the JAX gateway in tests/test_torch_gateway.py):
a stream admitted to a slot and stepped through any interleaving of pool
steps observes exactly the per-timestep running errors it would see alone
through ``AnomalyService.stream_step`` — batch rows are independent through
the LSTM cell, and unmasked slots carry their state unchanged.

Only the single placement exists in the port, so the block is one device's
(``Placement.pad_rows(capacity) == capacity``).
"""
from __future__ import annotations

from typing import Hashable, Mapping, Optional

import numpy as np
import torch

from repro_torch.engine.base import Engine
from repro_torch.gateway.telemetry import Telemetry

# the state dict's keys in the order jax.tree_util.tree_leaves gives them
# (sorted), so exported rows move between the two packages unchanged:
# every c leaf first, then every h leaf
_STATE_KEYS = ("c", "h")


class PoolFullError(RuntimeError):
    """Admission rejected: every slot is occupied (the gateway's
    fixed-capacity admission contract — callers shed or retry)."""


class UnknownStreamError(KeyError):
    """A stream id that is not resident in the pool."""


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t`` (a CPU tensor's
    ``.numpy()`` would alias it)."""
    return t.detach().cpu().numpy().copy()


class SessionPool:
    """Fixed-capacity pooled streaming over one :class:`Engine`.

    >>> pool = SessionPool(engine, capacity=32)
    >>> pool.admit("conn-7")
    >>> errors = pool.step({"conn-7": x_t})   # any subset of residents
    >>> final = pool.evict("conn-7")
    """

    def __init__(
        self,
        engine: Engine,
        capacity: int,
        telemetry: Optional[Telemetry] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.engine = engine
        self.capacity = capacity
        self.features = engine.cfg.lstm_ae.input_features
        self.telemetry = telemetry or Telemetry()
        self.placement = engine.placement
        self._block = self.placement.pad_rows(capacity)
        dev = engine.device
        self._state = engine.init_stream_state(self._block)
        self._sq_sum = torch.zeros((self._block,), dtype=torch.float32, device=dev)
        self._steps = torch.zeros((self._block,), dtype=torch.int32, device=dev)
        # the pool step's CUDA graph (None when the engine runs eagerly)
        self._graphs = engine.new_graph_cache()
        self._slot_of: dict[Hashable, int] = {}
        # descending, so pop() hands out the lowest free slot first
        self._free = list(range(capacity - 1, -1, -1))

    # -- membership -------------------------------------------------------

    @property
    def active(self) -> int:
        return len(self._slot_of)

    @property
    def resident(self) -> tuple:
        return tuple(self._slot_of)

    def admit(self, stream_id: Hashable) -> int:
        """Claim a slot for ``stream_id`` (zeroed state); raises
        :class:`PoolFullError` when no slot is free."""
        if stream_id in self._slot_of:
            raise ValueError(f"stream {stream_id!r} is already resident")
        if not self._free:
            self.telemetry.count("pool.rejected")
            raise PoolFullError(
                f"pool at capacity ({self.capacity}); evict a stream first"
            )
        slot = self._free.pop()
        self._slot_of[stream_id] = slot
        self._zero(slot)
        self.telemetry.count("pool.admitted")
        self._gauge_occupancy()
        return slot

    def evict(self, stream_id: Hashable) -> float:
        """Release the stream's slot; returns its final running error."""
        slot = self._require(stream_id)
        final = float(self.errors()[slot])
        del self._slot_of[stream_id]
        self._free.append(slot)
        self.telemetry.count("pool.evicted")
        self._gauge_occupancy()
        return final

    def _gauge_occupancy(self) -> None:
        self.telemetry.gauge("pool.active", self.active)
        self.telemetry.gauge("pool.occupancy", self.active / self.capacity)

    def reset(self, stream_id: Hashable) -> None:
        """Zero a resident stream's state and error counters in place."""
        self._zero(self._require(stream_id))

    def _require(self, stream_id: Hashable) -> int:
        try:
            return self._slot_of[stream_id]
        except KeyError:
            raise UnknownStreamError(
                f"stream {stream_id!r} is not resident (admit it first)"
            ) from None

    def _zero(self, slot: int) -> None:
        # in place: the block's tensors belong to the pool alone.  One row
        # per admit, so it stays eager, as does restore's row load (the
        # reference jits them as _clear_slot and _load_slot)
        for key in _STATE_KEYS:
            for leaf in self._state[key]:
                leaf[slot] = 0.0
        self._sq_sum[slot] = 0.0
        self._steps[slot] = 0

    # -- stepping ---------------------------------------------------------

    def step(self, inputs: Mapping[Hashable, "np.ndarray"]) -> dict:
        """Advance every stream in ``inputs`` one timestep.

        ``inputs`` maps resident stream ids to their next sample ``(F,)``;
        any subset of residents may step (the rest carry unchanged).
        Returns {stream_id: running mean error so far} for stepped streams.
        """
        if not inputs:
            return {}
        t0 = self.telemetry.now()
        slots = [self._require(sid) for sid in inputs]
        x = np.zeros((self._block, self.features), np.float32)
        mask = np.zeros((self._block,), bool)
        for sid, slot in zip(inputs, slots):
            sample = np.asarray(inputs[sid], np.float32)
            if sample.shape != (self.features,):
                raise ValueError(
                    f"stream {sid!r}: expected sample shape ({self.features},), "
                    f"got {sample.shape}"
                )
            x[slot] = sample
            mask[slot] = True
        self.engine.run_program("mstep", self._advance, (x, mask), graphs=self._graphs)
        self.telemetry.record_pool_step(len(slots), self.capacity)
        errs = self.errors().cpu().numpy()
        # the readback waited for the device, so this wall time covers the
        # whole assemble + masked step + readback path of one pool step
        self.telemetry.observe_stage(
            "pool_step_ms", (self.telemetry.now() - t0) * 1e3
        )
        return {sid: float(errs[slot]) for sid, slot in zip(inputs, slots)}

    def _advance(self, x_t: torch.Tensor, keep: torch.Tensor) -> None:
        """The pool step, in place: every slot's (h, c) one masked
        timestep; the stepped slots' squared errors and step counts."""
        y_t, state = self.engine._masked_stream_step(x_t, self._state, keep)
        for key in _STATE_KEYS:
            for leaf, new in zip(self._state[key], state[key]):
                leaf.copy_(new)
        sq = torch.mean(torch.square(y_t.float() - x_t), dim=-1)
        self._sq_sum += torch.where(keep, sq, 0.0)
        self._steps += keep.to(torch.int32)

    @property
    def captures(self) -> int:
        """Captures of the pool step (0 when the engine runs eagerly)."""
        return 0 if self._graphs is None else self._graphs.captures

    # -- durability export / restore --------------------------------------
    #
    # Rows travel as plain numpy in the JAX package's tree-leaves order
    # (every c leaf, then every h leaf), so snapshots move between the two
    # packages unchanged.

    def _leaves(self) -> list:
        return [leaf for key in _STATE_KEYS for leaf in self._state[key]]

    def slot_of(self, stream_id: Hashable) -> int:
        """Resident slot index of ``stream_id`` (UnknownStreamError if not)."""
        return self._require(stream_id)

    def export_block(self) -> tuple[list, np.ndarray, np.ndarray]:
        """Host copy of the full slot block: (state leaves in tree-leaves
        order, each ``(block, ...)``; sq_sum ``(block,)``; steps ``(block,)``)."""
        return [_host(l) for l in self._leaves()], _host(self._sq_sum), _host(self._steps)

    def export_slot(self, stream_id: Hashable) -> tuple[list, float, int]:
        """Host copy of ONE stream's rows (state leaf rows in tree-leaves
        order, sq_sum, steps) — the park-on-disconnect path."""
        slot = self._require(stream_id)
        rows = [_host(l[slot]) for l in self._leaves()]
        return rows, float(self._sq_sum[slot]), int(self._steps[slot])

    def restore(self, stream_id: Hashable, rows, sq_sum: float,
                steps: int) -> int:
        """Admit ``stream_id`` into a free slot and load previously exported
        state rows + error counters into it.  ``rows`` is a sequence of
        per-leaf arrays in tree-leaves order (as produced by
        :meth:`export_slot` / a sliced :meth:`export_block`)."""
        leaves = self._leaves()
        expect = [tuple(l.shape[1:]) for l in leaves]
        rows = [np.asarray(r) for r in rows]
        got = [r.shape for r in rows]
        if got != expect:
            raise ValueError(
                f"restore rows for {stream_id!r} do not match this pool's "
                f"state layout: got {got}, expected {expect} (arch mismatch?)"
            )
        slot = self.admit(stream_id)
        for leaf, row in zip(leaves, rows):
            leaf[slot] = torch.tensor(row, dtype=leaf.dtype, device=leaf.device)
        self._sq_sum[slot] = float(sq_sum)
        self._steps[slot] = int(steps)
        self.telemetry.count("pool.restored")
        return slot

    def errors(self) -> torch.Tensor:
        """Running mean error per slot (block,), on the engine's device."""
        return self._sq_sum / torch.clamp(self._steps, min=1).float()

    def error_of(self, stream_id: Hashable) -> float:
        return float(self.errors()[self._require(stream_id)])

    def __repr__(self) -> str:
        return (f"SessionPool(capacity={self.capacity}, active={self.active}, "
                f"schedule={self.engine.schedule.tag})")
