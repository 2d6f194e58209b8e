"""AnomalyService: the paper's deployment scenario as one object.

fit (train on benign windows) -> calibrate (threshold on a benign split)
-> score / detect (batched windows) -> stream (per-timestep state +
running errors) -> ``open_gateway`` (the session pool and micro-batcher of
``repro_torch.gateway``), on a named execution schedule and one device.
Counterpart of ``repro/engine/service.py``.  Weights come from the seeded
init, from ``fit``, or through ``recalibrate(params=...)``.
"""
from __future__ import annotations

import functools
import types
import weakref
from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.config.core import ModelConfig, TrainConfig
from repro_torch.config.registry import get_config
from repro_torch.core.anomaly import DetectionReport, calibrate_threshold, evaluate_detection
from repro_torch.core.latency import LatencyEstimate
from repro_torch.core.lstm import init_lstm_ae
from repro_torch.data.timeseries import TimeseriesConfig, make_batch
from repro_torch.engine.base import Engine, EngineConfig, build_engine
from repro_torch.models.lstm_ae import train_loss
from repro_torch.obs import trace
from repro_torch.utils import Params

_UNSET = object()  # distinguishes "not given" from an explicit None


@dataclass
class StreamSession:
    """Carried state of one streaming connection: per-layer (h, c) plus the
    running sum of squared reconstruction error per series."""
    state: Params
    sq_err_sum: torch.Tensor   # (B,)
    steps: int

    @property
    def errors(self) -> torch.Tensor:
        """Mean squared reconstruction error so far, per series (B,)."""
        return self.sq_err_sum / max(1, self.steps)


class AnomalyService:
    """End-to-end anomaly detection on a pluggable execution engine.

    >>> svc = AnomalyService("lstm-ae-f64-d6", schedule="fused")   # on the GPU
    >>> svc.calibrate(TimeseriesConfig(features=64, seq_len=64, batch=8192))
    >>> report = svc.detect(series, labels)
    """

    def __init__(
        self,
        model: Union[str, ModelConfig],
        schedule: Union[str, EngineConfig] = "wavefront",
        *,
        seed: int = 0,
        device=None,
    ):
        cfg = get_config(model) if isinstance(model, str) else model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.engine: Engine = build_engine(cfg, schedule, device=self.device)
        self.seed = seed
        gen = torch.Generator().manual_seed(seed)
        self.params: Params = self.engine.bind(init_lstm_ae(gen, cfg, self.device)).params
        self.threshold: Optional[float] = None
        # open gateways, weakly held so a dropped gateway is collectable;
        # _bind rebinds every one whose engine is not ours (a gateway opened
        # on another placement has its own) on a param swap
        self._gateways: "weakref.WeakSet" = weakref.WeakSet()

    def _bind(self, params: Params) -> None:
        """Swap ``params`` onto this service AND every open gateway engine,
        so no gateway serves stale params."""
        self.params = self.engine.bind(params).params
        for gw in list(self._gateways):
            if gw.engine is not self.engine:
                gw.engine.bind(self.params)

    @property
    def features(self) -> int:
        return self.cfg.lstm_ae.input_features

    # -- fit --------------------------------------------------------------

    def fit(
        self,
        data_cfg: TimeseriesConfig,
        steps: int,
        train_cfg: Optional[TrainConfig] = None,
        log_every: int = 0,
    ) -> dict:
        """Train on benign windows drawn from ``data_cfg``; binds the fitted
        params onto the engine and every open gateway.  Returns the final
        metrics as floats (empty when ``steps == 0`` — the service then
        scores with its init params).

        Training starts from the seeded init (this service's seed, drawn
        anew, as the reference re-inits from ``PRNGKey(seed)``) and runs
        eagerly on the service's device, autograd over plain ops in f32
        (TF32 stays as the caller set it; PyTorch's default is off)."""
        if steps <= 0:
            return {}
        from repro_torch.training import build_train_step, init_train_state

        tc = train_cfg or TrainConfig(
            learning_rate=5e-3, warmup_steps=min(10, steps), total_steps=steps
        )
        gen = torch.Generator().manual_seed(self.seed)
        state = init_train_state(init_lstm_ae(gen, self.cfg, self.device), tc)
        api = types.SimpleNamespace(loss=functools.partial(train_loss, cfg=self.cfg))
        step = build_train_step(api, tc)
        metrics: dict = {}
        for i in range(steps):
            series, _ = make_batch(data_cfg, i)
            state, metrics = step(state, {"series": series.to(self.device)})
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"step {i:4d}  mse={float(metrics['loss']):.4f}")
        self._bind(state.params)
        return {k: float(v) for k, v in metrics.items()}

    # -- calibrate --------------------------------------------------------

    def calibrate(
        self,
        benign: Union[TimeseriesConfig, torch.Tensor],
        k_sigma: float = 3.0,
        seed: int = 99_999,
    ) -> float:
        """Threshold = mean + k*std of scores on a benign split.  ``benign``
        is either a series batch (B, T, F) or a TimeseriesConfig to draw one."""
        if isinstance(benign, TimeseriesConfig):
            benign, _ = make_batch(benign, seed)
        self.threshold = calibrate_threshold(self.score(benign), k_sigma=k_sigma)
        return self.threshold

    def recalibrate(
        self,
        benign: Union[TimeseriesConfig, torch.Tensor, None] = None,
        *,
        threshold=_UNSET,
        params: Optional[Params] = None,
        k_sigma: float = 3.0,
        seed: int = 99_999,
    ) -> Optional[float]:
        """Refresh the live detector in place.

        Optionally rebinds ``params`` (tensors or numpy arrays, e.g. weights
        carried from the JAX package) onto the engine, then swaps the
        threshold: either ``threshold`` directly (an explicit None disables
        alerting; omit it to leave the threshold alone), or re-derived from
        a ``benign`` split after the param swap.  Returns the threshold now
        in effect."""
        if params is not None:
            self._bind(params)
        if threshold is not _UNSET:
            self.threshold = None if threshold is None else float(threshold)
        elif benign is not None:
            self.calibrate(benign, k_sigma=k_sigma, seed=seed)
        return self.threshold

    # -- batch scoring ----------------------------------------------------

    def score(self, series) -> torch.Tensor:
        """(B, T, F) -> per-sequence reconstruction errors (B,), on the device.
        The root span of a request (``repro_torch.service.score``) where the
        port's tracer is live."""
        if not trace.PROGRAM.live():
            return self.engine.score({"series": series})
        with trace.PROGRAM.span("repro_torch.service.score"):
            return self.engine.score({"series": series})

    def alerts(self, series) -> torch.Tensor:
        """(B, T, F) -> boolean alert mask (B,); requires calibration."""
        return self.score(series) > self._require_threshold()

    def detect(self, series, labels) -> DetectionReport:
        """Score + evaluate against ground-truth labels (B,)."""
        return evaluate_detection(self.score(series), labels, self._require_threshold())

    def _require_threshold(self) -> float:
        if self.threshold is None:
            raise ValueError("service is not calibrated; call calibrate(...) first")
        return self.threshold

    # -- streaming --------------------------------------------------------

    def stream_start(self, batch: int) -> StreamSession:
        return StreamSession(
            state=self.engine.init_stream_state(batch),
            sq_err_sum=torch.zeros((batch,), dtype=torch.float32, device=self.device),
            steps=0,
        )

    def stream_step(self, x_t, session: StreamSession) -> tuple[torch.Tensor, StreamSession]:
        """One timestep x_t (B, F); returns (running errors (B,), session)."""
        x_t = torch.as_tensor(x_t, device=self.device)
        y_t, state = self.engine.stream(x_t, session.state)
        sq = torch.mean(torch.square(y_t.float() - x_t.float()), dim=-1)
        session = StreamSession(
            state=state, sq_err_sum=session.sq_err_sum + sq, steps=session.steps + 1
        )
        return session.errors, session

    # -- gateway ----------------------------------------------------------

    def open_gateway(
        self,
        *,
        capacity: int = 32,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        max_queue: int = 1024,
        max_seq_len: Optional[int] = None,
        placement=None,
        **kw,
    ):
        """Open a streaming/micro-batching gateway over this service.

        Returns a :class:`repro_torch.gateway.AnomalyGateway`: a
        ``capacity``-slot session pool (admit/step/evict over one masked
        step) plus a shape-bucketed one-shot scoring queue (flush on
        ``max_batch`` or ``max_wait_ms``, reject past ``max_queue`` pending
        or ``max_seq_len`` timesteps), on this service's device.  A
        ``placement`` other than the service engine's gives the gateway its
        own engine on it (``Placement.data(N)``: rows over N devices).  The
        gateway registers itself, so ``fit`` and ``recalibrate(params=...)``
        rebind its engine too."""
        from repro_torch.gateway import AnomalyGateway  # lazy: gateway imports engine

        return AnomalyGateway(
            self, capacity=capacity, max_batch=max_batch,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            max_seq_len=max_seq_len, placement=placement, **kw,
        )

    # -- analytics --------------------------------------------------------

    def latency_model(self, timesteps: int, **kw) -> LatencyEstimate:
        """Eq-1 accounting of the bound schedule (paper accelerator model)."""
        return self.engine.latency_model(timesteps, **kw)
