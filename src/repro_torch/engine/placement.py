"""Device placement of the engine and the gateway: data-parallel rows.

Counterpart of ``repro/engine/placement.py``.  A :class:`Placement` is a
frozen, hashable dataclass that rides in ``EngineConfig`` and the schedule
resolve-cache key, and tells the engine, the session pool and the
micro-batcher how to lay their rows out over devices:

>>> pl = Placement.data(2)               # 2-way data-parallel rows
>>> pl.mesh("cuda")                      # DeviceMesh over cuda:0, cuda:1
>>> pl.row_blocks(8)                     # [slice(0, 4), slice(4, 8)]
>>> pl.pad_rows(7)                       # -> 8 (per-device multiple)

``devices`` is the port's stand-in for ``jax.devices()``.  Empty, it means
every visible GPU from ``cuda:0`` up on CUDA, and on the CPU as many
``"cpu"`` devices as a request needs (the counterpart of the reference's
``--xla_force_host_platform_device_count``).  Given, it may name a device
more than once: ``Placement.data(2, devices=("cuda:0", "cuda:0"))`` runs
two shards on one card, each on its own CUDA stream, which is how one GPU
emulates two.  Asking for more shards than distinct GPUs without
``devices=`` raises; nothing degrades to fewer devices.

* **Single-device no-op** — ``Placement.single()`` (the default) changes
  nothing: no mesh is built and the programs are the unsharded ones.
* **Contiguous row blocks** — device *d* of *n* holds rows
  ``[d*rows/n, (d+1)*rows/n)`` (``row_blocks``), which is what makes
  per-device slot occupancy and flush fill observable host-side.
"""
from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import torch


@dataclass(frozen=True)
class DeviceMesh:
    """A grid of devices with named axes (the port's ``jax.sharding.Mesh``).

    ``devices`` lists the cells in row-major order; a device may repeat.
    Each CUDA cell has its own stream (``stream(*index)``), made at first
    use and kept with the mesh, so work on two cells of one card can
    overlap."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices: tuple[torch.device, ...]
    _streams: dict = field(default_factory=dict, compare=False, hash=False, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, compare=False,
                                  hash=False, repr=False)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def _flat(self, index: Sequence[int]) -> int:
        flat = 0
        for i, n in zip(index, self.shape):
            if not 0 <= i < n:
                raise IndexError(f"mesh index {tuple(index)} outside shape {self.shape}")
            flat = flat * n + i
        return flat

    def device(self, *index: int) -> torch.device:
        """The device of the cell at ``index`` (one int per axis)."""
        return self.devices[self._flat(index)]

    def stream(self, *index: int) -> Optional["torch.cuda.Stream"]:
        """The cell's own CUDA stream (None for a CPU cell)."""
        dev = self.device(*index)
        if dev.type != "cuda":
            return None
        flat = self._flat(index)
        with self._lock:
            s = self._streams.get(flat)
            if s is None:
                s = self._streams[flat] = torch.cuda.Stream(dev)
            return s


def _device_names(devices) -> tuple[str, ...]:
    """``torch.device``s or names -> canonical names (``"cuda:0"``, ``"cpu"``)."""
    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}; expected 'cuda:N' or 'cpu'")
        out.append(str(dev))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _mesh_for(shape: tuple[int, ...], axis_names: tuple[str, ...],
              devices: tuple[str, ...]) -> DeviceMesh:
    """One cached mesh per (shape, names, devices): meshes hold streams, so
    they are process-global and must not be rebuilt per Engine."""
    gpus = torch.cuda.device_count() if any(d.startswith("cuda") for d in devices) else 0
    for d in devices:
        if d.startswith("cuda:") and int(d.split(":")[1]) >= gpus:
            raise ValueError(f"mesh names {d}, but {gpus} GPU(s) are visible")
    return DeviceMesh(shape, axis_names, tuple(torch.device(d) for d in devices))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Sequence[Union[str, torch.device]]) -> DeviceMesh:
    """The mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (which may repeat); raises ValueError when there are fewer."""
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
    need = math.prod(shape)
    devices = _device_names(devices)
    if len(devices) < need:
        raise ValueError(f"mesh {shape} needs {need} devices, have {len(devices)}")
    return _mesh_for(shape, names, devices[:need])


def visible_devices(platform: str) -> tuple[str, ...]:
    """Every visible GPU from ``cuda:0`` up (``platform="cuda"``), or the one
    CPU."""
    if platform == "cuda":
        return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    return ("cpu",)


@dataclass(frozen=True)
class Placement:
    """Declarative device placement: mesh axes and the devices under them.

    ``data_shards``  ways on the data axis — pool slots, micro-batch rows
                     and batched scoring rows split over it
    ``data_axis``    mesh axis name for the data dimension
    ``stage_axis``   mesh axis name pipeline stages use (the pipelined
                     schedule builds its own (data, stage) mesh)
    ``devices``      the devices to lay out over (see the module); empty
                     means the visible GPUs, or emulated CPU devices
    """

    data_shards: int = 1
    data_axis: str = "data"
    stage_axis: str = "model"
    devices: tuple[str, ...] = ()

    def __post_init__(self):
        if self.data_shards < 1:
            raise ValueError(f"data_shards must be >= 1, got {self.data_shards}")
        if self.data_axis == self.stage_axis:
            raise ValueError(
                f"data_axis and stage_axis must differ, both {self.data_axis!r}"
            )
        # names, not torch.device objects: the placement is hashed into the
        # resolve-cache key, and "cuda:0" must equal torch.device("cuda", 0)
        object.__setattr__(self, "devices", _device_names(self.devices))

    # -- constructors ------------------------------------------------------

    @classmethod
    def single(cls) -> "Placement":
        """The no-op placement: one device, no mesh, unchanged programs."""
        return cls()

    @classmethod
    def data(cls, n: int, *, data_axis: str = "data",
             devices: Sequence[Union[str, torch.device]] = ()) -> "Placement":
        """N-way data-parallel placement over ``devices`` (default: see the module)."""
        return cls(data_shards=n, data_axis=data_axis, devices=tuple(devices))

    @classmethod
    def from_spec(cls, spec: str) -> "Placement":
        """Parse a CLI mesh spec like ``"data=4"`` (the ``--mesh`` flag).

        Only the ``data`` axis is placeable from the CLI; unknown axes fail
        loudly rather than being dropped.
        """
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

    @property
    def devices_needed(self) -> int:
        return self.data_shards

    def pad_rows(self, n: int) -> int:
        """Round ``n`` up to a per-device multiple (at least 1 row)."""
        s = self.data_shards
        return ((max(n, 1) + s - 1) // s) * s

    def shard_of_row(self, row: int, n_rows: int) -> int:
        """Which data shard holds ``row`` of ``n_rows`` (contiguous blocks)."""
        return row // (n_rows // self.data_shards)

    def row_blocks(self, n_rows: int) -> list[slice]:
        """The contiguous rows each data shard holds: shard *d* has
        ``[d*n/D, (d+1)*n/D)`` (the reference's ``row_sharding()``)."""
        s = self.data_shards
        return [slice(d * n_rows // s, (d + 1) * n_rows // s) for d in range(s)]

    def device_pool(self, platform: str, need: Optional[int] = None) -> tuple[str, ...]:
        """The devices this placement may use on ``platform`` ("cuda" or
        "cpu"): ``devices`` when given; else the visible GPUs; else, on the
        CPU, ``need`` emulated CPU devices (one when ``need`` is None)."""
        if self.devices:
            return self.devices
        if platform == "cuda":
            return visible_devices("cuda")
        return ("cpu",) * (need or 1)

    # -- mesh (lazy; never built for the single placement) -----------------

    def mesh(self, device: Union[str, torch.device, None] = None) -> DeviceMesh:
        """The 1-D data mesh (cached per process) for an engine on
        ``device`` (its platform picks the default pool; None means CUDA).
        Raises with a clear message when fewer than ``data_shards``
        devices exist."""
        platform = "cuda" if device is None else torch.device(device).type
        pool = self.device_pool(platform, self.data_shards)
        if len(pool) < self.data_shards:
            kind = "GPU(s) are visible" if not self.devices else "devices are named"
            raise ValueError(
                f"placement needs {self.data_shards} devices on the "
                f"{self.data_axis!r} axis, but {len(pool)} {kind}; pass "
                f"devices=('cuda:0',) * {self.data_shards} to emulate them on "
                f"one GPU, or shrink the placement"
            )
        return make_mesh((self.data_shards,), (self.data_axis,), pool)

    def describe(self) -> dict:
        """Telemetry-friendly summary (surfaced by ``gateway.stats()``)."""
        return {
            "data": self.data_shards,
            "data_axis": self.data_axis,
            "stage_axis": self.stage_axis,
        }

    def __repr__(self) -> str:
        devices = f", devices={self.devices!r}" if self.devices else ""
        if not self.is_sharded:
            return f"Placement(devices={self.devices!r})" if devices else "Placement.single()"
        return (f"Placement.data({self.data_shards}, "
                f"data_axis={self.data_axis!r}{devices})")


__all__ = ["DeviceMesh", "Placement", "make_mesh", "visible_devices"]
