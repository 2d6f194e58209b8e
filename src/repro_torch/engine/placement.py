"""Device placement of the engine and the gateway, on one GPU.

Counterpart of ``repro/engine/placement.py``.  A :class:`Placement` is a
frozen, hashable dataclass that rides in ``EngineConfig`` and the schedule
resolve-cache key, and tells the session pool and the micro-batcher how
to lay out their rows (``pad_rows``, ``data_shards``).

Only the single placement exists here: data-parallel rows over several
GPUs wait for the multi-GPU slice, so asking for more than one data shard
raises ``NotImplementedError`` (as the ``pipelined`` schedule does for two
or more stages).  There are no mesh or sharding methods.
"""
from __future__ import annotations

from dataclasses import dataclass

MULTI_GPU_ITEM = "ROADMAP.md, queue 1, item 10 (Multi-GPU)"


@dataclass(frozen=True)
class Placement:
    """Declarative device placement.

    ``data_shards``  ways on the data axis (1: the only one ported)
    """

    data_shards: int = 1

    def __post_init__(self):
        if self.data_shards < 1:
            raise ValueError(f"data_shards must be >= 1, got {self.data_shards}")
        if self.data_shards > 1:
            raise NotImplementedError(
                f"a placement with data_shards={self.data_shards} needs rows "
                f"over several GPUs, which is not ported yet: {MULTI_GPU_ITEM}")

    # -- constructors ------------------------------------------------------

    @classmethod
    def single(cls) -> "Placement":
        """The no-op placement: one device."""
        return cls()

    @classmethod
    def data(cls, n: int) -> "Placement":
        """N-way data-parallel placement (raises for n > 1, see the module)."""
        return cls(data_shards=n)

    @classmethod
    def from_spec(cls, spec: str) -> "Placement":
        """Parse a CLI mesh spec like ``"data=1"``; unknown axes fail loudly."""
        out: dict[str, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            axis, sep, n = part.partition("=")
            axis = axis.strip()
            if not sep or axis not in ("data",):
                raise ValueError(
                    f"bad mesh spec {part!r}: expected data=N (axes "
                    f"supported: data)"
                )
            try:
                out[axis] = int(n)
            except ValueError:
                raise ValueError(f"bad mesh spec {part!r}: {n!r} is not an int")
        return cls.data(out.get("data", 1))

    # -- queries -----------------------------------------------------------

    @property
    def is_sharded(self) -> bool:
        return self.data_shards > 1

    def pad_rows(self, n: int) -> int:
        """Round ``n`` up to a per-device multiple (at least 1 row)."""
        s = self.data_shards
        return ((max(n, 1) + s - 1) // s) * s

    def shard_of_row(self, row: int, n_rows: int) -> int:
        """Which data shard holds ``row`` of ``n_rows`` (contiguous blocks)."""
        return row // (n_rows // self.data_shards)

    def describe(self) -> dict:
        """Telemetry-friendly summary, with the reference's keys; the axis
        names are the reference's defaults, as no mesh is built here."""
        return {"data": self.data_shards, "data_axis": "data", "stage_axis": "model"}

    def __repr__(self) -> str:
        return "Placement.single()"   # the only placement that constructs


__all__ = ["Placement"]
