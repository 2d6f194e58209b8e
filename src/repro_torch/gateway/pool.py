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

Under a sharded :class:`~repro_torch.engine.placement.Placement` the slot
block itself distributes over the data shards — contiguous row blocks of
``slots_per_device`` slots per device, each block's (h, c) and error sums
on its shard's device — so capacity scales to ``slots_per_device x
shards``.  The pool step runs per device, on each shard's stream and in
the pool's own graph cache for that shard; admission balances new streams
onto the least-loaded device, padding rows of an uneven block are never
admitted, and per-device occupancy is gauged as ``pool.device_active``.
Exported snapshot leaves are gathered in global row order, so a sharded
pool's snapshot restores into an unsharded pool (and the JAX package's).
The single placement is a strict no-op: one block, the same programs.

Semantics contract (held to the JAX gateway in tests/test_torch_gateway.py
and, for the sharded layout, tests/test_torch_placement.py): a stream
admitted to a slot and stepped through any interleaving of pool steps
observes exactly the per-timestep running errors it would see alone
through ``AnomalyService.stream_step`` — batch rows are independent through
the LSTM cell, and unmasked slots carry their state unchanged.
"""
from __future__ import annotations

import functools
from typing import Hashable, Mapping, Optional

import numpy as np
import torch

from repro_torch.engine.base import Engine
from repro_torch.gateway.telemetry import Telemetry
from repro_torch.models.lstm_ae import init_stream_state

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


class _Block:
    """One device's rows of the slot block, and the graphs that step them."""

    def __init__(self, engine: Engine, rows: int, device: torch.device):
        self.state = init_stream_state(engine.cfg, rows, device=device)
        self.sq_sum = torch.zeros((rows,), dtype=torch.float32, device=device)
        self.steps = torch.zeros((rows,), dtype=torch.int32, device=device)
        # the pool step's CUDA graph (None when the engine runs eagerly)
        self.graphs = engine.new_graph_cache(device)

    def leaves(self) -> list:
        return [leaf for key in _STATE_KEYS for leaf in self.state[key]]

    def errors(self) -> torch.Tensor:
        return self.sq_sum / torch.clamp(self.steps, min=1).float()


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
        # the pool lays its block out on the engine's placement: the masked
        # step and the slot state must agree on one layout (re-place through
        # Engine.with_placement, not a pool knob).  The block pads up to a
        # per-device multiple; the padding rows are never admitted
        self.placement = engine.placement
        self._block = self.placement.pad_rows(capacity)
        n_dev = self.placement.data_shards
        self.slots_per_device = self._block // n_dev
        devices = engine.shard_devices or [engine.device]
        self._blocks = [_Block(engine, self.slots_per_device, dev) for dev in devices]
        self._slot_of: dict[Hashable, int] = {}
        # per-device free stacks and active counts: admission picks the
        # least-loaded device, then pops its lowest free slot (descending
        # stacks); only logical slots (< capacity) are ever free
        self._free_count = capacity
        self._free_by_dev: list[list[int]] = [[] for _ in range(n_dev)]
        for slot in range(capacity - 1, -1, -1):
            self._free_by_dev[slot // self.slots_per_device].append(slot)
        self._active_by_dev = [0] * n_dev

    # -- membership -------------------------------------------------------

    @property
    def active(self) -> int:
        return len(self._slot_of)

    @property
    def resident(self) -> tuple:
        return tuple(self._slot_of)

    def device_of_slot(self, slot: int) -> int:
        """Which data shard holds ``slot`` (contiguous row blocks)."""
        return slot // self.slots_per_device

    def per_device_active(self) -> list:
        """Resident stream count per data shard — the imbalance view (a
        single-entry list under the single placement)."""
        return list(self._active_by_dev)

    def _pick_slot(self) -> int:
        """Pop a free slot from the least-loaded device that has one (ties
        to the lower device), so resident streams spread over the shards;
        on one device, the lowest free slot."""
        dev = min((d for d, stack in enumerate(self._free_by_dev) if stack),
                  key=lambda d: (self._active_by_dev[d], d))
        self._free_count -= 1
        self._active_by_dev[dev] += 1
        return self._free_by_dev[dev].pop()

    def admit(self, stream_id: Hashable) -> int:
        """Claim a slot for ``stream_id`` (zeroed state); raises
        :class:`PoolFullError` when no slot is free."""
        if stream_id in self._slot_of:
            raise ValueError(f"stream {stream_id!r} is already resident")
        if not self._free_count:
            self.telemetry.count("pool.rejected")
            raise PoolFullError(
                f"pool at capacity ({self.capacity}); evict a stream first"
            )
        slot = self._pick_slot()
        self._slot_of[stream_id] = slot
        self._zero(slot)
        self.telemetry.count("pool.admitted")
        self._gauge_occupancy()
        return slot

    def evict(self, stream_id: Hashable) -> float:
        """Release the stream's slot; returns its final running error."""
        slot = self._require(stream_id)
        final = self.error_of(stream_id)
        del self._slot_of[stream_id]
        dev = self.device_of_slot(slot)
        self._free_by_dev[dev].append(slot)
        self._free_count += 1
        self._active_by_dev[dev] -= 1
        self.telemetry.count("pool.evicted")
        self._gauge_occupancy()
        return final

    def _gauge_occupancy(self) -> None:
        self.telemetry.gauge("pool.active", self.active)
        self.telemetry.gauge("pool.occupancy", self.active / self.capacity)
        if self.placement.is_sharded:
            self.telemetry.gauge_vec("pool.device_active", self.per_device_active())

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

    def _locate(self, slot: int) -> tuple[_Block, int]:
        """The block that holds ``slot`` and the slot's row in it."""
        return self._blocks[slot // self.slots_per_device], slot % self.slots_per_device

    def _zero(self, slot: int) -> None:
        # in place: the block's tensors belong to the pool alone.  One row
        # per admit, so it stays eager, as does restore's row load (the
        # reference jits them as _clear_slot and _load_slot)
        blk, row = self._locate(slot)
        for leaf in blk.leaves():
            leaf[row] = 0.0
        blk.sq_sum[row] = 0.0
        blk.steps[row] = 0

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
        if self.placement.is_sharded:
            blocks = [(x[rows], mask[rows]) for rows in self.placement.row_blocks(self._block)]
            self.engine.run_on_shards("mstep", self._advance, blocks,
                                      graphs=[blk.graphs for blk in self._blocks])
        else:
            self.engine.run_program("mstep", functools.partial(self._advance, 0), (x, mask),
                                    graphs=self._blocks[0].graphs)
        self.telemetry.record_pool_step(len(slots), self.capacity)
        errs = self.errors().cpu().numpy()
        # the readback waited for the device, so this wall time covers the
        # whole assemble + masked step + readback path of one pool step
        self.telemetry.observe_stage(
            "pool_step_ms", (self.telemetry.now() - t0) * 1e3
        )
        return {sid: float(errs[slot]) for sid, slot in zip(inputs, slots)}

    def _advance(self, i: int, x_t: torch.Tensor, keep: torch.Tensor) -> None:
        """The pool step of block ``i``, in place: every slot's (h, c) one
        masked timestep; the stepped slots' squared errors and step counts."""
        blk = self._blocks[i]
        params = (self.engine.shard_params(i) if self.placement.is_sharded
                  else self.engine._require_params())
        y_t, state = self.engine._masked_stream_step(params, x_t, blk.state, keep)
        for key in _STATE_KEYS:
            for leaf, new in zip(blk.state[key], state[key]):
                leaf.copy_(new)
        sq = torch.mean(torch.square(y_t.float() - x_t), dim=-1)
        blk.sq_sum += torch.where(keep, sq, 0.0)
        blk.steps += keep.to(torch.int32)

    @property
    def captures(self) -> int:
        """Captures of the pool step, over every shard's cache (0 when the
        engine runs eagerly)."""
        return sum(blk.graphs.captures for blk in self._blocks if blk.graphs is not None)

    # -- durability export / restore --------------------------------------
    #
    # Rows travel as plain numpy in the JAX package's tree-leaves order
    # (every c leaf, then every h leaf), so snapshots move between the two
    # packages unchanged.

    def slot_of(self, stream_id: Hashable) -> int:
        """Resident slot index of ``stream_id`` (UnknownStreamError if not)."""
        return self._require(stream_id)

    def export_block(self) -> tuple[list, np.ndarray, np.ndarray]:
        """Host copy of the full slot block, gathered in global row order:
        (state leaves in tree-leaves order, each ``(block, ...)``; sq_sum
        ``(block,)``; steps ``(block,)``)."""
        per_block = [blk.leaves() for blk in self._blocks]
        leaves = [np.concatenate([_host(leaves[i]) for leaves in per_block])
                  for i in range(len(per_block[0]))]
        return (leaves, np.concatenate([_host(blk.sq_sum) for blk in self._blocks]),
                np.concatenate([_host(blk.steps) for blk in self._blocks]))

    def export_slot(self, stream_id: Hashable) -> tuple[list, float, int]:
        """Host copy of ONE stream's rows (state leaf rows in tree-leaves
        order, sq_sum, steps) — the park-on-disconnect path."""
        blk, row = self._locate(self._require(stream_id))
        rows = [_host(l[row]) for l in blk.leaves()]
        return rows, float(blk.sq_sum[row]), int(blk.steps[row])

    def restore(self, stream_id: Hashable, rows, sq_sum: float,
                steps: int) -> int:
        """Admit ``stream_id`` into a free slot and load previously exported
        state rows + error counters into it.  ``rows`` is a sequence of
        per-leaf arrays in tree-leaves order (as produced by
        :meth:`export_slot` / a sliced :meth:`export_block`)."""
        leaves = self._blocks[0].leaves()
        expect = [tuple(l.shape[1:]) for l in leaves]
        rows = [np.asarray(r) for r in rows]
        got = [r.shape for r in rows]
        if got != expect:
            raise ValueError(
                f"restore rows for {stream_id!r} do not match this pool's "
                f"state layout: got {got}, expected {expect} (arch mismatch?)"
            )
        slot = self.admit(stream_id)
        blk, i = self._locate(slot)
        for leaf, row in zip(blk.leaves(), rows):
            leaf[i] = torch.tensor(row, dtype=leaf.dtype, device=leaf.device)
        blk.sq_sum[i] = float(sq_sum)
        blk.steps[i] = int(steps)
        self.telemetry.count("pool.restored")
        return slot

    def errors(self) -> torch.Tensor:
        """Running mean error per slot (block,), on the engine's device."""
        if len(self._blocks) == 1:
            return self._blocks[0].errors()
        return torch.cat([blk.errors().to(self.engine.device) for blk in self._blocks])

    def error_of(self, stream_id: Hashable) -> float:
        blk, row = self._locate(self._require(stream_id))
        return float(blk.errors()[row])

    def __repr__(self) -> str:
        pl = f", placement={self.placement!r}" if self.placement.is_sharded else ""
        return (f"SessionPool(capacity={self.capacity}, active={self.active}, "
                f"schedule={self.engine.schedule.tag}{pl})")
