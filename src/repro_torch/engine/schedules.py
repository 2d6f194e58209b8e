"""Named execution schedules for the LSTM-AE (paper Section 3).

Counterpart of ``repro/engine/schedules.py``.  Each schedule walks the
(layer x time) iteration grid of the recurrent stack its own way and is
selected by name:

* ``"sequential"`` — layer-by-layer: layer i runs over all timesteps
  before layer i+1 (plain PyTorch).
* ``"wavefront"``  — temporal-parallel dataflow (§3.2): at wavefront step k
  every layer fires on its own timestep, as one batched cell (plain PyTorch).
* ``"pipelined"``  — the stage pipeline over a (data, stage) device mesh
  (``core/temporal.py::pipelined_forward``); with fewer than two stages it
  degenerates to the wavefront schedule.
* ``"fused"``      — the hand-written CUDA kernels: at a small batch (one
  window a request, the gateway's flushes) the whole stack in one launch on
  the wavefront schedule (``kernels/lstm_stack.py``); at a large one (bulk
  scoring) the LSTM cell (``kernels/lstm_cell.py``, K1) once per (layer,
  timestep), walked layer by layer.

Third-party backends register with :func:`register_schedule`.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import TYPE_CHECKING, Callable, NamedTuple, Optional

import torch

from repro_torch.config.core import ModelConfig
from repro_torch.core.lstm import lstm_ae_sequential
from repro_torch.core.temporal import (
    build_stage_params,
    place_stages,
    run_pipeline,
    wavefront_forward,
)
from repro_torch.engine.placement import make_mesh
from repro_torch.kernels import lstm_stack
from repro_torch.kernels.lstm_cell import pack_weights
from repro_torch.kernels.ops import lstm_cell_op, lstm_stack_op
from repro_torch.utils import Params

if TYPE_CHECKING:
    from repro_torch.engine.base import EngineConfig

# (params, xs (T, B, F)) -> reconstruction (T, B, F)
ForwardFn = Callable[[Params, torch.Tensor], torch.Tensor]


class Schedule(NamedTuple):
    """A resolved schedule: the executor plus its Eq-1 accounting kind.

    ``prepare`` (optional) turns bound params into what ``forward`` reads
    (the pipeline's stage cells on their devices); the Engine calls it once
    per bind.  ``prejitted`` schedules manage their own devices and
    streams, so the Engine never captures their batch programs into one
    CUDA graph (the reference's ``prejitted``: never wrapped in a jit)."""
    name: str            # requested registry name
    resolved: str        # actual executor after fallbacks (may differ)
    latency_kind: str    # "dataflow" | "sequential" (core.latency Eq-1 mode)
    forward: ForwardFn
    prepare: Optional[Callable[[Params], object]] = None
    prejitted: bool = False

    @property
    def tag(self) -> str:
        """Display form: the requested name, plus the resolved executor
        when it differs (e.g. ``pipelined->wavefront``)."""
        return self.name if self.resolved == self.name else f"{self.name}->{self.resolved}"


# name -> factory(cfg, engine_cfg) -> Schedule
_SCHEDULES: dict[str, Callable[[ModelConfig, "EngineConfig"], Schedule]] = {}
# name -> EngineConfig field names the factory reads (None = all), so configs
# differing only in fields a schedule ignores share one cached Schedule
_SCHEDULE_FIELDS: dict[str, Optional[tuple[str, ...]]] = {}
# names whose factory also takes the engine's platform ("cuda" | "cpu"): the
# devices a placement may use depend on it
_PER_PLATFORM: set = set()

SCHEDULE_CACHE_CAPACITY = 32
_RESOLVE_CACHE: "OrderedDict[tuple, Schedule]" = OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0}


def register_schedule(name: str, *, config_fields: Optional[tuple[str, ...]] = None,
                      per_platform: bool = False):
    """Register a schedule factory under ``name`` (decorator).

    The factory receives ``(model_cfg, engine_cfg)`` and returns a
    :class:`Schedule` whose ``forward`` maps ``(params, xs (T,B,F))`` to the
    reconstruction ``(T,B,F)``.  ``config_fields`` names the
    :class:`EngineConfig` fields the factory reads; omit it to key the
    resolve cache on every field.  A ``per_platform`` factory also receives
    the engine's platform (``"cuda"`` or ``"cpu"``) as a third argument,
    which then joins the cache key."""
    def deco(factory):
        _SCHEDULES[name] = factory
        _SCHEDULE_FIELDS[name] = config_fields
        if per_platform:
            _PER_PLATFORM.add(name)
        else:
            _PER_PLATFORM.discard(name)
        _RESOLVE_CACHE.clear()  # re-registration must not serve stale entries
        return factory
    return deco


def unregister_schedule(name: str) -> None:
    """Remove a registered schedule and drop its cached resolutions."""
    _SCHEDULES.pop(name, None)
    _SCHEDULE_FIELDS.pop(name, None)
    _PER_PLATFORM.discard(name)
    _RESOLVE_CACHE.clear()


def available_schedules() -> list[str]:
    return sorted(_SCHEDULES)


def schedule_cache_info() -> dict:
    """Resolve-cache occupancy and its hit/miss counters (the schema of
    ``repro.engine.schedules.schedule_cache_info``)."""
    return {
        "size": len(_RESOLVE_CACHE),
        "capacity": SCHEDULE_CACHE_CAPACITY,
        "always_keyed": ("schedule", "placement"),
        "placements": sorted({repr(k[2].placement) for k in _RESOLVE_CACHE}),
        "hits": _CACHE_STATS["hits"],
        "misses": _CACHE_STATS["misses"],
    }


def _canonical_cfg(name: str, engine_cfg: "EngineConfig") -> "EngineConfig":
    """Project ``engine_cfg`` onto the fields schedule ``name`` reads; the
    placement is always part of the key."""
    fields = _SCHEDULE_FIELDS.get(name)
    if fields is None:
        return dataclasses.replace(engine_cfg, schedule=name)
    from repro_torch.engine.base import EngineConfig

    return EngineConfig(schedule=name, placement=engine_cfg.placement,
                        **{f: getattr(engine_cfg, f) for f in fields})


def resolve_schedule(name: str, cfg: ModelConfig, engine_cfg: "EngineConfig",
                     device=None) -> Schedule:
    """Look up ``name`` in the registry and build its executor for an
    engine on ``device`` (None: the GPU), cached per (name, cfg, canonical
    engine_cfg[, platform]) in a capped LRU."""
    if name not in _SCHEDULES:
        raise ValueError(
            f"unknown schedule {name!r}; available schedules: "
            f"{', '.join(available_schedules())}"
        )
    platform = None
    if name in _PER_PLATFORM:
        platform = "cuda" if device is None else torch.device(device).type
    key = (name, cfg, _canonical_cfg(name, engine_cfg), platform)
    sched = _RESOLVE_CACHE.get(key)
    if sched is None:
        _CACHE_STATS["misses"] += 1
        factory = _SCHEDULES[name]
        sched = factory(cfg, key[2], platform) if platform else factory(cfg, key[2])
        _RESOLVE_CACHE[key] = sched
        while len(_RESOLVE_CACHE) > SCHEDULE_CACHE_CAPACITY:
            _RESOLVE_CACHE.popitem(last=False)
    else:
        _CACHE_STATS["hits"] += 1
        _RESOLVE_CACHE.move_to_end(key)
    return sched


def resolve_forward(name: str, cfg: ModelConfig, *, pwl: bool = False,
                    n_stages: Optional[int] = None, device=None) -> ForwardFn:
    """Schedule name -> ForwardFn(params, xs) with a default EngineConfig,
    for data on ``device`` (None: the GPU)."""
    from repro_torch.engine.base import EngineConfig

    ecfg = EngineConfig(schedule=name, pwl=pwl, n_stages=n_stages)
    sched = resolve_schedule(name, cfg, ecfg, device=device)
    if sched.prepare is None:
        return sched.forward
    return lambda params, xs: sched.forward(sched.prepare(params), xs)


@register_schedule("sequential", config_fields=("pwl",))
def _sequential(cfg: ModelConfig, ecfg: "EngineConfig") -> Schedule:
    def forward(params, xs):
        return lstm_ae_sequential(params, xs, pwl=ecfg.pwl)

    return Schedule("sequential", "sequential", "sequential", forward)


@register_schedule("wavefront", config_fields=("pwl",))
def _wavefront(cfg: ModelConfig, ecfg: "EngineConfig") -> Schedule:
    def forward(params, xs):
        return wavefront_forward(params, xs, pwl=ecfg.pwl)

    return Schedule("wavefront", "wavefront", "dataflow", forward)


# The ``fused`` forward runs one ``lstm_stack`` launch while
#   B · (T + D − 1) · w  <=  STACK_CROSSOVER · D · T,
# w the weights a thread of the stack's widest layer holds: the stack's time
# grows with its rows, its T + D − 1 wavefront steps and the step's dot (w),
# the K1 chain's with its D · T launches, nearly flat in B up to 2,048 rows.
# Fitted to the crossover sweep on an H100 at T = 8 … 64 (PERF.md): the
# stack up to 769–1,159 rows at lstm-ae-f64-d6 (w = 96) and 1,481–1,641 at
# lstm-ae-f32-d2 (w = 24), each just under where K1's chain takes the lead.
STACK_CROSSOVER = 20_000


def stack_max_batch(dims, t_len: int) -> int:
    """The largest batch the ``fused`` forward runs as one ``lstm_stack``
    launch for a stack of layers (In, H) that fits (``lstm_stack.fits``)
    over windows of ``t_len`` (:data:`STACK_CROSSOVER`)."""
    depth = len(dims)
    return (STACK_CROSSOVER * depth * t_len
            // ((t_len + depth - 1) * lstm_stack.slice_width(dims)))


def fused_takes_stack(layers, xs: torch.Tensor) -> bool:
    """Whether the ``fused`` forward runs ``layers`` over xs (T, B, F) as one
    ``lstm_stack`` launch: f32 xs and weights on one CUDA device (or meta,
    the dry run's), a stack the kernel fits (``lstm_stack.fits``) and
    B <= :func:`stack_max_batch` at this T.  Decided from what the call can
    see, at capture time under a CUDA graph.  On the CPU the forward keeps
    K1's chain of plain cells, which is the stack's plain version step for
    step (the same numbers, bit for bit)."""
    tensors = [xs] + [layer[k] for layer in layers for k in ("wx", "wh", "b")]
    dims = lstm_stack.layer_dims(layers)
    return (xs.device.type in ("cuda", "meta") and xs.dim() == 3
            and all(t.dtype == torch.float32 and t.device == xs.device for t in tensors)
            and lstm_stack.fits(dims) and dims[0][0] == xs.shape[2]
            and xs.shape[1] <= stack_max_batch(dims, xs.shape[0]))


def fused_launches(layers, xs: torch.Tensor) -> dict[str, int]:
    """The kernel launches of one ``fused`` forward of ``layers`` over xs."""
    if fused_takes_stack(layers, xs):
        return {"lstm_stack": 1}
    return {"lstm_cell": len(layers) * xs.shape[0]}


@register_schedule("fused", config_fields=("pwl",))
def _fused(cfg: ModelConfig, ecfg: "EngineConfig") -> Schedule:
    """The hand-written kernels, by batch.  Up to :func:`stack_max_batch`
    rows (:func:`fused_takes_stack`), the whole stack in one ``lstm_stack``
    launch: every layer fires at each wavefront step, T + D − 1 dependent
    steps inside one kernel.  Above it, K1 once per (layer, timestep), layer
    by layer: the paper's single-module datapath as one kernel launch per
    cell step, which keeps the card's SMs busy at a large batch.

    K1's path packs the weights once per forward.  Each step writes h' in
    place into the layer's output buffer (``ys[t]``, which is the next step's
    h) and updates c in place, so a layer allocates only ys and c."""
    def forward(params, xs):
        if fused_takes_stack(params["layers"], xs):
            return lstm_stack_op(params["layers"], xs, pwl=ecfg.pwl)
        ys = xs.contiguous()
        t_len, bsz, _ = xs.shape
        for layer in params["layers"]:
            packed = pack_weights(layer)
            hidden = packed[1].shape[1]
            out = torch.empty((t_len, bsz, hidden), dtype=xs.dtype, device=xs.device)
            h = torch.zeros((bsz, hidden), dtype=xs.dtype, device=xs.device)
            c = torch.zeros((bsz, hidden), dtype=torch.float32, device=xs.device)
            for t in range(t_len):
                h, c = lstm_cell_op(packed, ys[t], h, c, pwl=ecfg.pwl, h_out=out[t], c_out=c)
            ys = out
        return ys

    return Schedule("fused", "fused", "sequential", forward)


@register_schedule("pipelined", config_fields=("pwl", "n_stages"), per_platform=True)
def _pipelined(cfg: ModelConfig, ecfg: "EngineConfig", platform: str) -> Schedule:
    """The stage pipeline over a (data, stage) mesh of the placement's
    devices (``Placement.device_pool``: its ``devices``, else the visible
    GPUs, else on the CPU as many as an explicit ``n_stages`` needs).

    ``n_stages`` defaults to ``min(len(devices) // data, depth)``.  Under two
    stages the pipeline degenerates to the wavefront schedule (same dataflow
    semantics, no stage axis; Eq-1 accounting stays "dataflow"), unless the
    placement asked for data shards, which must never silently collapse
    onto one device.  Stage cells are built once per bind (``prepare``), and
    the schedule is ``prejitted``: one CUDA graph cannot span the stages'
    devices and streams."""
    if cfg.lstm_ae is None:
        raise ValueError("pipelined schedule requires an lstm_ae config")
    depth = len(cfg.lstm_ae.layer_sizes())
    pl = ecfg.placement
    data_par = pl.data_shards
    need = data_par * ecfg.n_stages if ecfg.n_stages else None
    devices = pl.device_pool(platform, need)
    n_stages = ecfg.n_stages or min(len(devices) // data_par, depth)

    if n_stages < 2:
        if data_par > 1:
            raise ValueError(
                f"pipelined schedule with Placement.data({data_par}) needs "
                f"at least {2 * data_par} devices (2 stages x {data_par}), "
                f"have {len(devices)}"
            )
        wf = _wavefront(cfg, ecfg)
        return Schedule("pipelined", "wavefront", "dataflow", wf.forward)

    need = data_par * n_stages
    if len(devices) < need:
        raise ValueError(
            f"pipelined schedule needs {need} devices "
            f"({data_par} data x {n_stages} stages), have {len(devices)}"
        )
    mesh = make_mesh((data_par, n_stages), (pl.data_axis, pl.stage_axis), devices[:need])

    def prepare(params):
        stage_params, counts, _ = build_stage_params(params, cfg, n_stages)
        return place_stages(stage_params, counts, mesh, stage_axis=pl.stage_axis,
                            batch_axes=(pl.data_axis,))

    def forward(grid, xs):
        return run_pipeline(grid, xs, pwl=ecfg.pwl)

    return Schedule("pipelined", "pipelined", "dataflow", forward,
                    prepare=prepare, prejitted=True)
