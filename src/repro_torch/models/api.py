"""Uniform model API: one entry point per family.

Counterpart of ``repro/models/api.py``.  ``build_model(cfg)`` returns a
:class:`ModelAPI` with:

- init(generator, device=None) -> params, drawn on ``device`` (default
  cuda) from ``generator``, which must live on that device for the
  transformer (the LSTM-AE draws on the CPU and moves its params)
- loss(params, batch) -> (scalar, metrics)
- prefill(params, batch) -> (logits/scores, cache)
- decode(params, token, cache, cache_len) -> (logits, cache), the cache
  written in place
- init_cache(batch, max_len, device=None) -> decode state
- stitch(prefill_cache, max_len) -> the decode cache that continues a
  prefill (None where the family has no prefill-then-decode)

The port builds every family of the reference: "transformer" (dense and
MoE), "rwkv6", "jamba", "whisper" and "lstm_ae"; the LMs' ``loss`` is
their ``train_loss`` (a MoE layer adds ``aux_weight`` times its
load-balance loss).  RWKV-6's decode cache is its recurrent state
(``init_cache`` and ``stitch`` ignore ``max_len``: the state is
position-free, and the prefill's state is the decode cache as it is).
Jamba's mixes the two: a KV cache at its attention position, stitched to
``max_len`` positions, and the Mamba states passed through as they are.
Whisper's holds the decoder's self-KV, stitched to ``max_len`` positions,
and the cross-KV of the encoder's memory, passed through as it is.  A
family listed in ``UNPORTED_FAMILIES`` (none today) raises
``NotImplementedError`` naming the ROADMAP item that ports it.
The reference's ``param_specs``/``cache_specs`` (sharding) and its
``input_specs``/``cache_struct``/``param_struct`` (the dry-run launcher)
come with ROADMAP.md, queue 1, item 11g.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config.core import ModelConfig
from repro_torch.core.lstm import init_lstm_ae
from repro_torch.models import jamba as jamba_m
from repro_torch.models import lstm_ae as lstm_ae_m
from repro_torch.models import rwkv6 as rwkv6_m
from repro_torch.models import transformer as tf_m
from repro_torch.models import whisper as whisper_m
from repro_torch.utils import Params

# family -> the ROADMAP item that ports it
UNPORTED_FAMILIES: dict[str, str] = {}


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Params]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    prefill: Callable[..., tuple[torch.Tensor, Params]]
    decode: Optional[Callable[..., tuple[torch.Tensor, Params]]]
    init_cache: Optional[Callable[..., Params]]
    stitch: Optional[Callable[[Params, int], Params]] = None


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "transformer":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: tf_m.init_transformer(gen, cfg, resolve_device(device)),
            loss=lambda p, b, **kw: tf_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: tf_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: tf_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: tf_m.init_decode_cache(
                cfg, batch, max_len, device=resolve_device(device)),
            stitch=lambda cache, max_len: tf_m.stitch_decode_cache(cfg, cache, max_len),
        )
    if cfg.family == "rwkv6":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: rwkv6_m.init_rwkv6(gen, cfg, resolve_device(device)),
            loss=lambda p, b, **kw: rwkv6_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: rwkv6_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: rwkv6_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: rwkv6_m.init_state(
                cfg, batch, device=resolve_device(device)),
            stitch=lambda state, max_len: state,
        )
    if cfg.family == "jamba":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: jamba_m.init_jamba(gen, cfg, resolve_device(device)),
            loss=lambda p, b, **kw: jamba_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: jamba_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: jamba_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: jamba_m.init_states(
                cfg, batch, max_len, device=resolve_device(device)),
            stitch=lambda states, max_len: jamba_m.stitch_states(cfg, states, max_len),
        )
    if cfg.family == "whisper":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: whisper_m.init_whisper(gen, cfg, resolve_device(device)),
            loss=lambda p, b, **kw: whisper_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: whisper_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: whisper_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: whisper_m.init_decode_cache(
                cfg, batch, max_len, device=resolve_device(device)),
            stitch=lambda cache, max_len: whisper_m.stitch_decode_cache(cfg, cache, max_len),
        )
    if cfg.family == "lstm_ae":
        # prefill runs a named engine schedule: pass schedule=... through kw
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: init_lstm_ae(gen, cfg, device),
            loss=lambda p, b, **kw: lstm_ae_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: lstm_ae_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: lstm_ae_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: lstm_ae_m.init_stream_state(
                cfg, batch, device=device),
        )
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {UNPORTED_FAMILIES[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
