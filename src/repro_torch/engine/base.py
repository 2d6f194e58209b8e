"""The execution engine: one surface over every temporal schedule.

Counterpart of ``repro/engine/base.py``.  An :class:`Engine` binds a model
config and parameters to a *named* execution schedule from the registry in
``engine/schedules.py``, on one device:

    engine = build_engine(cfg, "fused", params=params)   # device defaults to cuda
    recon  = engine.reconstruct(batch)    # (B, T, F)
    errors = engine.score(batch)          # (B,) per-sequence MSE
    y, st  = engine.stream(x_t, st)       # one timestep, carried state
    est    = engine.latency_model(T)      # Eq-1 accounting for this schedule

Inputs may be CPU tensors or numpy arrays; they are moved to the engine's
device, and results stay there.  The engine carries a
:class:`~repro_torch.engine.placement.Placement`; only the single
placement exists until the multi-GPU slice.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.core import ModelConfig
from repro_torch.core.latency import PAPER_RH_M, LatencyEstimate, fpga_latency_ms
from repro_torch.engine.placement import Placement
from repro_torch.engine.schedules import Schedule, resolve_schedule
from repro_torch.models.lstm_ae import decode_step, init_stream_state
from repro_torch.utils import Params, params_from_numpy


@dataclass(frozen=True)
class EngineConfig:
    """Declarative engine selection — everything needed to resolve a schedule.

    ``schedule``  registry name ("sequential" | "wavefront" | "fused" | "pipelined")
    ``pwl``       piecewise-linear activations (the paper's HLS numerics)
    ``n_stages``  pipeline stages (pipelined; one GPU runs one stage)
    ``placement`` device placement (only ``Placement.single()`` until the
                  multi-GPU slice)
    """
    schedule: str = "wavefront"
    pwl: bool = False
    n_stages: Optional[int] = None
    placement: Placement = Placement.single()


def _as_engine_cfg(schedule: Union[str, EngineConfig]) -> EngineConfig:
    if isinstance(schedule, EngineConfig):
        return schedule
    return EngineConfig(schedule=schedule)


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
            self.engine_cfg.schedule, cfg, self.engine_cfg
        )
        self.params = None
        if params is not None:
            self.bind(params)
        # first call per (program, shape): its wall time, see profile_info
        self._seen_shapes: set = set()
        self.profile: dict = {"compiles": 0, "compile_ms": 0.0, "per_program": {}}

    # -- placement ---------------------------------------------------------

    @property
    def placement(self) -> Placement:
        """The device placement this engine runs on."""
        return self.engine_cfg.placement

    def with_placement(self, placement: Placement) -> "Engine":
        """An engine on the same model, schedule, params and device with
        ``placement``; returns self when the placement already matches."""
        if placement == self.placement:
            return self
        ecfg = dataclasses.replace(self.engine_cfg, placement=placement)
        return Engine(self.cfg, ecfg, params=self.params, device=self.device)

    # -- profiling ---------------------------------------------------------

    def _run_profiled(self, name: str, fn, shape: tuple, *args):
        """Call ``fn(*args)``; on the first call per (program, shape) record
        its host wall time under ``name``.  Later calls cost one set lookup."""
        key = (name, shape)
        if key in self._seen_shapes:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        ms = (time.perf_counter() - t0) * 1e3
        self._seen_shapes.add(key)
        self.profile["compiles"] += 1
        self.profile["compile_ms"] += ms
        per = self.profile["per_program"].setdefault(
            name, {"compiles": 0, "compile_ms": 0.0, "shapes": []})
        per["compiles"] += 1
        per["compile_ms"] += ms
        per["shapes"].append(list(shape))
        return out

    def profile_info(self) -> dict:
        """First-call profile in the schema of ``repro.engine.Engine.profile_info``.

        The port compiles no programs, so "compiles" counts first calls per
        (program, shape) and "compile_ms" is their host wall time: the
        kernel build and load (first launch in the process), the caching
        allocator's warm-up and the enqueue.  Device work still in flight
        when the call returns is not in it."""
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
        """Bind parameters (tensors or numpy arrays), moved to the engine's
        device; returns self."""
        self.params = params_from_numpy(params, self.device)
        return self

    def _require_params(self) -> Params:
        if self.params is None:
            raise ValueError("engine has no bound params; call bind(params)")
        return self.params

    def _on_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, device=self.device)

    # -- batch surface ----------------------------------------------------

    def _forward(self, series: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        xs = self._on_device(series).transpose(0, 1)                 # (T, B, F)
        return xs, self.schedule.forward(self._require_params(), xs)

    def _reconstruct(self, series) -> torch.Tensor:
        _, recon = self._forward(series)
        return recon.transpose(0, 1)

    def _score(self, series) -> torch.Tensor:
        xs, recon = self._forward(series)
        return torch.mean(torch.square(recon.float() - xs.float()), dim=(0, 2))

    def _score_masked(self, series, lengths) -> torch.Tensor:
        xs, recon = self._forward(series)
        lengths = self._on_device(lengths).to(torch.int64)
        sq = torch.mean(torch.square(recon.float() - xs.float()), dim=2)   # (T, B)
        valid = torch.arange(sq.shape[0], device=self.device)[:, None] < lengths[None, :]
        denom = torch.clamp(lengths, min=1).float()
        return torch.where(valid, sq, 0.0).sum(dim=0) / denom

    def reconstruct(self, batch: dict) -> torch.Tensor:
        """batch {"series": (B, T, F)} -> reconstruction (B, T, F)."""
        series = batch["series"]
        return self._run_profiled("reconstruct", self._reconstruct, tuple(series.shape), series)

    def score(self, batch: dict) -> torch.Tensor:
        """batch {"series": (B, T, F)} -> per-sequence reconstruction MSE (B,)
        — the anomaly score of the paper's application."""
        series = batch["series"]
        return self._run_profiled("score", self._score, tuple(series.shape), series)

    def score_masked(self, batch: dict) -> torch.Tensor:
        """batch {"series": (B, T, F), "lengths": (B,) int} -> per-sequence
        MSE over each row's first ``lengths[i]`` timesteps.  The stack is
        causal, so end-padding does not perturb the valid timesteps — the
        gateway's bucketed-scoring primitive."""
        series = batch["series"]
        return self._run_profiled("score_masked", self._score_masked, tuple(series.shape),
                                  series, batch["lengths"])

    # -- streaming surface ------------------------------------------------

    def init_stream_state(self, batch: int, dtype=torch.float32) -> Params:
        """Zero (h, c) per layer for a streaming session of ``batch`` series."""
        return init_stream_state(self.cfg, batch, dtype, device=self.device)

    def _stream_step(self, x_t, state: Params) -> tuple[torch.Tensor, Params]:
        return decode_step(self._require_params(), self._on_device(x_t), state, None,
                           self.cfg, pwl=self.engine_cfg.pwl)

    def _masked_stream_step(self, x_t, state: Params, mask) -> tuple[torch.Tensor, Params]:
        # rows are independent through the cell, so a masked step equals
        # stepping each selected row alone
        y_t, new_state = self._stream_step(x_t, state)
        keep = self._on_device(mask).to(torch.bool)[:, None]
        merged = {k: tuple(torch.where(keep, new, old) for new, old in zip(new_state[k], state[k]))
                  for k in ("h", "c")}
        return y_t, merged

    def stream(self, x_t, state: Params) -> tuple[torch.Tensor, Params]:
        """One streaming timestep x_t (B, F) -> (reconstruction (B, F), state).
        A single timestep admits no temporal parallelism, so every schedule
        streams through the same cell loop."""
        return self._run_profiled("step", self._stream_step, tuple(x_t.shape), x_t, state)

    def stream_masked(self, x_t, state: Params, mask) -> tuple[torch.Tensor, Params]:
        """Pooled step: x_t (B, F), mask (B,) bool -> (y_t (B, F), state)
        where only masked rows' (h, c) advance (others carry unchanged).
        The gateway's session pool steps all its slots through this."""
        return self._run_profiled("mstep", self._masked_stream_step, tuple(x_t.shape),
                                  x_t, state, mask)

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
        return (f"Engine({self.cfg.name}, schedule={self.schedule.tag}, "
                f"device={self.device}, bound={self.params is not None})")


def build_engine(model: ModelConfig, schedule: Union[str, EngineConfig] = "wavefront",
                 params: Optional[Params] = None, device=None) -> Engine:
    """Build an :class:`Engine` from a ModelConfig; ``schedule`` is a
    registry name or a full :class:`EngineConfig`."""
    if not isinstance(model, ModelConfig):
        raise TypeError(f"expected ModelConfig, got {type(model)!r}")
    return Engine(model, schedule, params=params, device=device)
