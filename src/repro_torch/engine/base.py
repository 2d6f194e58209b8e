"""The execution engine: one surface over every temporal schedule.

Counterpart of ``repro/engine/base.py``.  An :class:`Engine` binds a model
config and parameters to a *named* execution schedule from the registry in
``engine/schedules.py``, on one device:

    engine = build_engine(cfg, "fused", params=params)   # device defaults to cuda
    recon  = engine.reconstruct(batch)    # (B, T, F)
    errors = engine.score(batch)          # (B,) per-sequence MSE
    y, st  = engine.stream(x_t, st)       # one timestep, carried state
    errors = engine.score_with(p, batch)  # the same under params p
    est    = engine.latency_model(T)      # Eq-1 accounting for this schedule

Inputs may be CPU tensors or numpy arrays; they are moved to the engine's
device, and results stay there.  On a CUDA device with
``EngineConfig.jit`` (the default) every program is captured into one CUDA
graph per input signature at its first call and replayed after
(``engine/capture.py``), the counterpart of the reference's ``jax.jit``; on
the CPU, or with ``jit=False``, programs run eagerly.

Each form also takes params per call (``reconstruct_with``, ``score_with``,
``score_masked_with``, ``stream_with``, ``stream_masked_with``: the form the
serving steps use).  Those are programs of their own, captured like the
bound forms, with the params as inputs that each call copies in: they never
touch the engine's weights, so a later bound call is unchanged.

The engine carries a :class:`~repro_torch.engine.placement.Placement`.
Under ``Placement.data(N)`` the row programs (reconstruct, score,
score_masked, step, mstep) run data-parallel: the params are replicated
once per shard device at ``bind``, each shard runs the unsharded program
on its contiguous block of rows on its own device and stream (captured in
its own graph cache: a graph replays only on the device it was captured
on), and the results are gathered onto the engine's device.  A batch whose
rows do not divide over the shards runs the unsharded program, with the
same values (the rows are independent).  A ``prejitted`` schedule (the
pipeline) lays its own batch out, so only the streaming programs shard
under it, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.core import ModelConfig
from repro_torch.core.latency import PAPER_RH_M, LatencyEstimate, fpga_latency_ms
from repro_torch.engine.capture import GraphCache, signature
from repro_torch.engine.placement import Placement
from repro_torch.engine.schedules import Schedule, resolve_schedule
from repro_torch.models.lstm_ae import decode_step, init_stream_state
from repro_torch.obs import trace
from repro_torch.utils import Params, tree_map


@dataclass(frozen=True)
class EngineConfig:
    """Declarative engine selection — everything needed to resolve a schedule.

    ``schedule``  registry name ("sequential" | "wavefront" | "fused" | "pipelined")
    ``pwl``       piecewise-linear activations (the paper's HLS numerics)
    ``n_stages``  pipeline stages (pipelined; default: min(devices, depth))
    ``placement`` device placement: data-parallel rows, the devices under
                  them and the pipeline's axis names (default: one device)
    ``jit``       on a CUDA device, capture each program into a CUDA graph
                  per input signature (the reference's ``jax.jit``); the
                  CPU always runs eagerly
    """
    schedule: str = "wavefront"
    pwl: bool = False
    n_stages: Optional[int] = None
    placement: Placement = Placement.single()
    jit: bool = True


def _as_engine_cfg(schedule: Union[str, EngineConfig]) -> EngineConfig:
    if isinstance(schedule, EngineConfig):
        return schedule
    return EngineConfig(schedule=schedule)


class _Shard(NamedTuple):
    """One data shard of a sharded engine: its device, stream and graphs."""
    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    graphs: Optional[GraphCache]


@contextlib.contextmanager
def _on_stream(stream):
    """Run the block on ``stream``, after the work queued so far on its
    device's current stream; that stream then waits for the block."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        current.wait_stream(stream)


def _rows(a, rows: slice):
    return a[rows]


class Engine:
    """A model bound to one named temporal schedule on one device."""

    def __init__(
        self,
        cfg: ModelConfig,
        engine_cfg: Union[str, EngineConfig] = "wavefront",
        params: Optional[Params] = None,
        device=None,
    ):
        if cfg.family != "lstm_ae" or cfg.lstm_ae is None:
            raise ValueError(
                f"Engine executes the paper's lstm_ae family; got {cfg.family!r}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.engine_cfg = _as_engine_cfg(engine_cfg)
        self.schedule: Schedule = resolve_schedule(
            self.engine_cfg.schedule, cfg, self.engine_cfg, device=self.device
        )
        # the engine's captured programs, and every cache that captured a
        # program over its weights (its own and its pools'; a pool's graph
        # dies with the pool): a bind that allocates new weights drops them
        self._graphs: Optional[GraphCache] = None
        self._caches: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()
        if self.device.type == "cuda" and self.engine_cfg.jit:
            self._graphs = self.new_graph_cache()
        # a sharded placement's shards (raises here, at construction, when
        # the devices it needs do not exist)
        self._shards: list[_Shard] = []
        if self.placement.is_sharded:
            mesh = self.placement.mesh(self.device)
            self._shards = [_Shard(i, mesh.device(i), mesh.stream(i),
                                   self.new_graph_cache(mesh.device(i)))
                            for i in range(mesh.size)]
        # eagerly, the (program, signature) pairs run so far; captured, the
        # caches' own programs say which calls capture
        self._seen: set = set()
        self.profile: dict = {"compiles": 0, "compile_ms": 0.0, "per_program": {}}
        self.params = None
        # what the programs read: the bound params themselves when eager,
        # the engine's own copy of them when captured (see bind); a copy of
        # those per other shard device; the schedule's prepared form
        self._weights = None
        self._replicas: dict[str, Params] = {}
        self._prepared = None
        if params is not None:
            self.bind(params)

    # -- placement ---------------------------------------------------------

    @property
    def placement(self) -> Placement:
        """The device placement this engine runs on."""
        return self.engine_cfg.placement

    def with_placement(self, placement: Placement) -> "Engine":
        """An engine on the same model, schedule, params and device with
        ``placement``; returns self when the placement already matches.
        Captured programs are not shared: the new engine captures its own."""
        if placement == self.placement:
            return self
        ecfg = dataclasses.replace(self.engine_cfg, placement=placement)
        return Engine(self.cfg, ecfg, params=self.params, device=self.device)

    # -- profiling ---------------------------------------------------------

    def new_graph_cache(self, device: Optional[torch.device] = None) -> Optional[GraphCache]:
        """A cache for programs captured over this engine's params on
        ``device`` (default: the engine's; None when the engine runs
        eagerly); :meth:`bind` drops its programs whenever it allocates new
        param tensors."""
        if self.device.type != "cuda" or not self.engine_cfg.jit:
            return None
        cache = GraphCache(self.device if device is None else device)
        self._caches.add(cache)
        return cache

    def run_program(self, name: str, fn, args: tuple, graphs: Optional[GraphCache] = None,
                    device: Optional[torch.device] = None, capture: bool = True):
        """``fn(*args)`` as program ``name``: eagerly on tensors on ``device``
        (default: the engine's), or through ``graphs`` (default: the
        engine's own cache) captured at its first call per signature and
        replayed after; ``capture=False`` runs eagerly.  ``args`` hold
        tensors or arrays (containers of them too).  Each capture (eagerly:
        the first call per (program, signature)) is timed into the profile
        by its ``repro_torch.engine.capture`` span; later calls cost one
        lookup, under spans of their own where ``trace.PROGRAM`` is live."""
        graphs = (graphs or self._graphs) if capture else None
        if not trace.PROGRAM.live():
            key, args, known = self._lookup(name, args, graphs, device)
            if known:
                return fn(*args) if graphs is None else graphs.run(key, fn, args)
        else:
            with trace.PROGRAM.span("repro_torch.engine.lookup", name):
                key, args, known = self._lookup(name, args, graphs, device)
            if known and graphs is not None:
                return graphs.run(key, fn, args)
            if known:
                with trace.PROGRAM.span("repro_torch.engine.eager", name):
                    return fn(*args)
        with trace.PROGRAM.span("repro_torch.engine.capture", name) as first:
            if graphs is None:
                out = fn(*args)
                self._seen.add(key)
            else:
                out = graphs.run(key, fn, args, name=name)
        ms = first.total_ms
        self.profile["compiles"] += 1
        self.profile["compile_ms"] += ms
        per = self.profile["per_program"].setdefault(
            name, {"compiles": 0, "compile_ms": 0.0, "shapes": []})
        per["compiles"] += 1
        per["compile_ms"] += ms
        per["shapes"].append(list(args[0].shape))
        return out

    def _lookup(self, name: str, args: tuple, graphs: Optional[GraphCache],
                device: Optional[torch.device]) -> tuple:
        """(key, args, whether the key ran before): eagerly the args moved to
        ``device``; captured, host data stays on the host (the static copy
        moves it)."""
        if graphs is None:
            dev = self.device if device is None else device
            args = tree_map(lambda a: self._on_device(a, dev), args)
            key = (name, signature(args))
            return key, args, key in self._seen
        args = tree_map(lambda a: a if isinstance(a, torch.Tensor)
                        else torch.as_tensor(np.asarray(a)), args)
        key = (name, signature(args))
        return key, args, key in graphs.programs

    def profile_info(self) -> dict:
        """First-call profile in the schema of ``repro.engine.Engine.profile_info``.

        "compiles" counts first calls per (program, input signature) and
        "compile_ms" their host wall time.  On a CUDA device with ``jit``
        each is a capture: the warm-up run (the kernel build and load on
        the first launch in the process, the caching allocator's warm-up)
        and the CUDA graph's capture; each pool captures its own step, each
        shard of a sharded placement its own programs (``score@shard0``,
        ``score@shard1``, ...), and a bind that drops the graphs makes the
        next call capture, and count, anew.  Eagerly (the CPU, or
        ``jit=False``) it is the first run's enqueue; device work still in
        flight when the call returns is not in it."""
        return {
            "schedule": self.schedule.tag,
            "compiles": self.profile["compiles"],
            "compile_ms": round(self.profile["compile_ms"], 3),
            "per_program": {
                name: {
                    "compiles": d["compiles"],
                    "compile_ms": round(d["compile_ms"], 3),
                    "shapes": list(d["shapes"]),
                }
                for name, d in self.profile["per_program"].items()
            },
        }

    # -- binding ----------------------------------------------------------

    def bind(self, params: Params) -> "Engine":
        """Bind parameters (tensors or numpy arrays) on the engine's device;
        returns self.  Nothing is cast, and the engine never writes into
        ``params``: ``self.params`` holds the caller's tensors (moved to the
        device where they are not on it), as the reference binds by
        reference.

        Eagerly the programs read ``self.params``.  Captured programs read
        the engine's own copy of them by address: params of the same
        containers, shapes and dtypes as the bound ones are copied into that
        copy in place, so the graphs serve them and none is recaptured (the
        reference's "compiled executors are reused").  Otherwise the engine
        makes a new copy and drops every captured program, to be captured
        anew at its next call.  Changing bound tensors in place reaches a
        captured engine only through the next bind.

        Every shard device of a sharded placement gets a replica of the
        weights by the same rule (the engine's own device reads
        ``self._weights``), and a schedule with ``prepare`` (the pipeline)
        rebuilds its prepared form, so no shard or stage serves stale
        weights."""
        self.params = tree_map(
            lambda a: (a.detach() if isinstance(a, torch.Tensor)
                       else torch.from_numpy(np.array(a))).to(self.device), params)
        in_place = (self._graphs is not None and self._weights is not None
                    and _layout(self.params) == _layout(self._weights))
        if self._graphs is None:
            self._weights = self.params
        elif in_place:
            with torch.no_grad():
                tree_map(lambda dst, src: dst.copy_(src), self._weights, self.params)
        else:
            self._weights = tree_map(lambda t: t.clone(), self.params)
            for cache in list(self._caches):
                cache.clear()
        for dev in {shard.device for shard in self._shards} - {self.device}:
            replica = self._replicas.get(str(dev))
            if in_place and replica is not None:
                with torch.no_grad():
                    tree_map(lambda dst, src: dst.copy_(src), replica, self._weights)
            else:
                self._replicas[str(dev)] = tree_map(lambda t: t.to(dev, copy=True),
                                                    self._weights)
        self._replicas[str(self.device)] = self._weights
        if self.schedule.prepare is not None:
            self._prepared = self.schedule.prepare(self._weights)
        return self

    def _require_params(self) -> Params:
        if self._weights is None:
            raise ValueError("engine has no bound params; call bind(params)")
        return self._weights

    def _on_device(self, a, device: torch.device) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, device=device)

    # -- shards -------------------------------------------------------------

    @property
    def shard_devices(self) -> list[torch.device]:
        """The device of each data shard (empty under the single placement)."""
        return [shard.device for shard in self._shards]

    def shard_params(self, i: int) -> Params:
        """The weights shard ``i`` reads, on its device."""
        self._require_params()
        return self._replicas[str(self._shards[i].device)]

    def run_on_shards(self, name: str, fn, blocks: list, graphs: Optional[list] = None) -> list:
        """``fn(i, *blocks[i])`` as program ``name@shard{i}`` for every shard
        i, each on its device and stream, captured in ``graphs[i]`` (default:
        the shard's own cache).  Returns the outputs (None for none) on the
        engine's device, in shard order, ordered before whatever the caller
        queues next."""
        caller = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        outs = []
        for shard, args in zip(self._shards, blocks):
            cache = shard.graphs if graphs is None else graphs[shard.index]
            with _on_stream(shard.stream):
                out = self.run_program(f"{name}@shard{shard.index}",
                                       functools.partial(fn, shard.index), args,
                                       graphs=cache, device=shard.device)
                if out is not None:
                    out = tree_map(functools.partial(_hand_back, self.device, caller), out)
                if caller is not None and shard.stream is not None:
                    caller.wait_stream(shard.stream)
            outs.append(out)
        return outs

    def _run_rows(self, name: str, program, args: tuple, batch: bool, params=None):
        """Program ``name``, ``program(params, *args)``, over the rows of
        ``args`` (leading dims): data-parallel over the shards when there are
        shards for it and the rows divide, else the unsharded program.

        ``params`` None is a bound form: the program reads the engine's own
        weights (a captured one by address; each shard its replica).  Else
        it is a ``*_with`` form, program ``{name}_with``: the caller's
        params are one more input, so a captured program copies them into
        static inputs of its own at each call (each shard into its own).
        Neither the engine's weights nor its bound programs change, and a
        later bound call computes what it computed before."""
        n = args[0].shape[0]
        prejitted = batch and self.schedule.prejitted
        prepare = self.schedule.prepare if batch else None
        sharded = bool(self._shards) and not prejitted and n % len(self._shards) == 0
        if params is not None:
            def with_params(*a):   # the params ride last among the inputs
                return program(a[-1] if prepare is None else prepare(a[-1]), *a[:-1])

            name = f"{name}_with"
            if not sharded:
                return self.run_program(name, with_params, args + (params,),
                                        capture=not prejitted)
            blocks = [tree_map(functools.partial(_rows, rows=rows), args) + (params,)
                      for rows in self.placement.row_blocks(n)]
            outs = self.run_on_shards(name, lambda i, *a: with_params(*a), blocks)
            return tree_map(lambda *parts: torch.cat(parts), *outs)
        weights = self._require_params()
        if not sharded:
            if prepare is not None:
                weights = self._prepared
            return self.run_program(name, functools.partial(program, weights), args,
                                    capture=not prejitted)
        blocks = [tree_map(functools.partial(_rows, rows=rows), args)
                  for rows in self.placement.row_blocks(n)]
        outs = self.run_on_shards(name, lambda i, *a: program(self.shard_params(i), *a), blocks)
        return tree_map(lambda *parts: torch.cat(parts), *outs)

    # -- batch surface ----------------------------------------------------

    # The programs below take the params they read and device tensors
    # (run_program moves the caller's data there) and run eagerly or under
    # capture alike.

    def _forward(self, params, series: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        xs = series.transpose(0, 1)                                   # (T, B, F)
        return xs, self.schedule.forward(params, xs)

    def _reconstruct(self, params, series) -> torch.Tensor:
        _, recon = self._forward(params, series)
        return recon.transpose(0, 1)

    # Each row's error is reduced along contiguous memory (over F, then over
    # T of a (B, T) copy): a row's score then does not depend on how many
    # rows share the call, so data shards equal the unsharded program bit
    # for bit (a reduction over T strided by B sums in a B-dependent order).

    @staticmethod
    def _row_errors(xs: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        """(T, B, F) pair -> per-timestep MSE over F, as (B, T)."""
        sq = torch.mean(torch.square(recon.float() - xs.float()), dim=2)   # (T, B)
        return sq.t().contiguous()

    def _score(self, params, series) -> torch.Tensor:
        xs, recon = self._forward(params, series)
        return self._row_errors(xs, recon).mean(dim=1)

    def _score_masked(self, params, series, lengths) -> torch.Tensor:
        xs, recon = self._forward(params, series)
        lengths = lengths.to(torch.int64)
        sq = self._row_errors(xs, recon)                                   # (B, T)
        valid = torch.arange(sq.shape[1], device=sq.device)[None, :] < lengths[:, None]
        denom = torch.clamp(lengths, min=1).float()
        return torch.where(valid, sq, 0.0).sum(dim=1) / denom

    def reconstruct_with(self, params: Params, batch: dict) -> torch.Tensor:
        """batch {"series": (B, T, F)} -> reconstruction (B, T, F) under
        ``params`` (tensors or arrays) instead of the bound ones."""
        return self._run_rows("reconstruct", self._reconstruct, (batch["series"],),
                              batch=True, params=params)

    def score_with(self, params: Params, batch: dict) -> torch.Tensor:
        """batch {"series": (B, T, F)} -> per-sequence reconstruction MSE (B,)
        — the anomaly score of the paper's application — under ``params``.
        Under a sharded placement the rows are scored data-parallel over the
        shards."""
        return self._run_rows("score", self._score, (batch["series"],), batch=True,
                              params=params)

    def score_masked_with(self, params: Params, batch: dict) -> torch.Tensor:
        """batch {"series": (B, T, F), "lengths": (B,) int} -> per-sequence
        MSE over each row's first ``lengths[i]`` timesteps, under ``params``.
        The stack is causal, so end-padding does not perturb the valid
        timesteps — the gateway's bucketed-scoring primitive (which pads B
        to a per-device multiple under a sharded placement)."""
        return self._run_rows("score_masked", self._score_masked,
                              (batch["series"], batch["lengths"]), batch=True, params=params)

    def reconstruct(self, batch: dict) -> torch.Tensor:
        """:meth:`reconstruct_with` under the bound params (the engine's own copy)."""
        return self._run_rows("reconstruct", self._reconstruct, (batch["series"],), batch=True)

    def score(self, batch: dict) -> torch.Tensor:
        """:meth:`score_with` under the bound params (the engine's own copy)."""
        return self._run_rows("score", self._score, (batch["series"],), batch=True)

    def score_masked(self, batch: dict) -> torch.Tensor:
        """:meth:`score_masked_with` under the bound params (the engine's own copy)."""
        return self._run_rows("score_masked", self._score_masked,
                              (batch["series"], batch["lengths"]), batch=True)

    # -- streaming surface ------------------------------------------------

    def init_stream_state(self, batch: int, dtype=torch.float32) -> Params:
        """Zero (h, c) per layer for a streaming session of ``batch`` series."""
        return init_stream_state(self.cfg, batch, dtype, device=self.device)

    def _stream_step(self, params, x_t, state: Params) -> tuple[torch.Tensor, Params]:
        return decode_step(params, x_t, state, None, self.cfg, pwl=self.engine_cfg.pwl)

    def _masked_stream_step(self, params, x_t, state: Params, mask) -> tuple[torch.Tensor, Params]:
        # rows are independent through the cell, so a masked step equals
        # stepping each selected row alone
        y_t, new_state = self._stream_step(params, x_t, state)
        keep = mask.to(torch.bool)[:, None]
        merged = {k: tuple(torch.where(keep, new, old) for new, old in zip(new_state[k], state[k]))
                  for k in ("h", "c")}
        return y_t, merged

    def stream_with(self, params: Params, x_t, state: Params) -> tuple[torch.Tensor, Params]:
        """One streaming timestep x_t (B, F) -> (reconstruction (B, F), state)
        under ``params``.  A single timestep admits no temporal parallelism,
        so every schedule streams through the same cell loop."""
        return self._run_rows("step", self._stream_step, (x_t, state), batch=False,
                              params=params)

    def stream_masked_with(self, params: Params, x_t, state: Params,
                           mask) -> tuple[torch.Tensor, Params]:
        """Pooled step under ``params``: x_t (B, F), mask (B,) bool ->
        (y_t (B, F), state) where only masked rows' (h, c) advance (others
        carry unchanged).  The gateway's session pool steps all its slots
        through the bound form."""
        return self._run_rows("mstep", self._masked_stream_step, (x_t, state, mask),
                              batch=False, params=params)

    def stream(self, x_t, state: Params) -> tuple[torch.Tensor, Params]:
        """:meth:`stream_with` under the bound params (the engine's own copy)."""
        return self._run_rows("step", self._stream_step, (x_t, state), batch=False)

    def stream_masked(self, x_t, state: Params, mask) -> tuple[torch.Tensor, Params]:
        """:meth:`stream_masked_with` under the bound params (the engine's own copy)."""
        return self._run_rows("mstep", self._masked_stream_step, (x_t, state, mask), batch=False)

    # -- analytics --------------------------------------------------------

    def latency_model(self, timesteps: int, rh_m: Optional[int] = None, **kw) -> LatencyEstimate:
        """Eq-1 accounting of THIS schedule on the paper's accelerator model.

        ``rh_m`` defaults to the paper's Table-1 bottleneck reuse factor for
        this architecture (1 when the arch is not a paper config)."""
        if rh_m is None:
            rh_m = PAPER_RH_M.get(self.cfg.name, 1)
        return fpga_latency_ms(
            self.cfg.lstm_ae, timesteps, rh_m,
            schedule=self.schedule.latency_kind, **kw,
        )

    def __repr__(self) -> str:
        pl = f", placement={self.placement!r}" if self.placement.is_sharded else ""
        return (f"Engine({self.cfg.name}, schedule={self.schedule.tag}, "
                f"device={self.device}{pl}, bound={self.params is not None})")


def _layout(tree: Params) -> Params:
    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


def _hand_back(device: torch.device, caller, t: torch.Tensor) -> torch.Tensor:
    """A shard's output on the engine's ``device``, issued on the shard's
    stream (the caller's stream then waits for it); marked as used on the
    caller's stream, so the allocator never hands its memory to the shard's
    stream while the caller still reads it."""
    out = t.to(device)
    if caller is not None:
        out.record_stream(caller)
    return out


def build_engine(model: ModelConfig, schedule: Union[str, EngineConfig] = "wavefront",
                 params: Optional[Params] = None, device=None) -> Engine:
    """Build an :class:`Engine` from a ModelConfig; ``schedule`` is a
    registry name or a full :class:`EngineConfig`."""
    if not isinstance(model, ModelConfig):
        raise TypeError(f"expected ModelConfig, got {type(model)!r}")
    return Engine(model, schedule, params=params, device=device)
