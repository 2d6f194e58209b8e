"""Uniform model API: one entry point per family, plus the dry-run
``input_specs``, ``cache_struct`` and ``param_struct`` (meta tensors: a
shape and a dtype, no storage).

Counterpart of ``repro/models/api.py``.  ``build_model(cfg)`` returns a
:class:`ModelAPI` with:

- init(generator, device=None) -> params, drawn on ``device`` (default
  cuda) from ``generator``, which must live on that device for the
  transformer (the LSTM-AE draws on the CPU and moves its params); on
  ``device="meta"`` a CPU generator draws nothing
- param_specs() -> logical-axis spec tree (mirrors params)
- loss(params, batch) -> (scalar, metrics)
- prefill(params, batch) -> (logits/scores, cache)
- decode(params, token, cache, cache_len) -> (logits, cache), the cache
  written in place
- init_cache(batch, max_len, device=None) -> decode state; cache_specs()
  its logical-axis spec tree (None for the LSTM-AE, as in the reference)
- stitch(prefill_cache, max_len) -> the decode cache that continues a
  prefill (None where the family has no prefill-then-decode)

The port builds every family of the reference: "transformer" (dense and
MoE), "rwkv6", "jamba", "whisper" and "lstm_ae", and a family of its own,
"deepseek_v3" (``models/deepseek_v3.py``: latent attention, DeepSeek-MoE),
for serving: its ``loss`` raises, its decode cache is the latent cache,
stitched to ``max_len`` positions.  The other LMs' ``loss`` is
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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.config.core import ModelConfig, ShapeConfig
from repro_torch.core.lstm import init_lstm_ae, lstm_ae_specs
from repro_torch.models import deepseek_v3 as ds_m
from repro_torch.models import jamba as jamba_m
from repro_torch.models import lstm_ae as lstm_ae_m
from repro_torch.models import rwkv6 as rwkv6_m
from repro_torch.models import transformer as tf_m
from repro_torch.models import whisper as whisper_m
from repro_torch.utils import Params, resolve_device_or_meta

# family -> the ROADMAP item that ports it
UNPORTED_FAMILIES: dict[str, str] = {}


def _serving_only(cfg: ModelConfig) -> Callable[..., tuple[torch.Tensor, dict]]:
    def loss(params, batch, **kw):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is ported for "
                                  f"serving (prefill and decode) only; it has no loss")
    return loss


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Params]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    prefill: Callable[..., tuple[torch.Tensor, Params]]
    decode: Optional[Callable[..., tuple[torch.Tensor, Params]]]
    init_cache: Optional[Callable[..., Params]]
    stitch: Optional[Callable[[Params, int], Params]] = None
    param_specs: Optional[Callable[[], Params]] = None
    cache_specs: Optional[Callable[[], Params]] = None


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "transformer":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: tf_m.init_transformer(
                gen, cfg, resolve_device_or_meta(device)),
            loss=lambda p, b, **kw: tf_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: tf_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: tf_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: tf_m.init_decode_cache(
                cfg, batch, max_len, device=resolve_device_or_meta(device)),
            stitch=lambda cache, max_len: tf_m.stitch_decode_cache(cfg, cache, max_len),
            param_specs=lambda: tf_m.transformer_specs(cfg),
            cache_specs=lambda: tf_m.decode_cache_specs(cfg),
        )
    if cfg.family == "rwkv6":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: rwkv6_m.init_rwkv6(
                gen, cfg, resolve_device_or_meta(device)),
            loss=lambda p, b, **kw: rwkv6_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: rwkv6_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: rwkv6_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: rwkv6_m.init_state(
                cfg, batch, device=resolve_device_or_meta(device)),
            stitch=lambda state, max_len: state,
            param_specs=lambda: rwkv6_m.rwkv6_specs(cfg),
            cache_specs=rwkv6_m.state_specs,
        )
    if cfg.family == "jamba":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: jamba_m.init_jamba(
                gen, cfg, resolve_device_or_meta(device)),
            loss=lambda p, b, **kw: jamba_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: jamba_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: jamba_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: jamba_m.init_states(
                cfg, batch, max_len, device=resolve_device_or_meta(device)),
            stitch=lambda states, max_len: jamba_m.stitch_states(cfg, states, max_len),
            param_specs=lambda: jamba_m.jamba_specs(cfg),
            cache_specs=lambda: jamba_m.state_specs(cfg),
        )
    if cfg.family == "whisper":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: whisper_m.init_whisper(
                gen, cfg, resolve_device_or_meta(device)),
            loss=lambda p, b, **kw: whisper_m.train_loss(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: whisper_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: whisper_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: whisper_m.init_decode_cache(
                cfg, batch, max_len, device=resolve_device_or_meta(device)),
            stitch=lambda cache, max_len: whisper_m.stitch_decode_cache(cfg, cache, max_len),
            param_specs=lambda: whisper_m.whisper_specs(cfg),
            cache_specs=lambda: whisper_m.decode_cache_specs(cfg),
        )
    if cfg.family == "deepseek_v3":
        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device=None: ds_m.init_deepseek_v3(
                gen, cfg, resolve_device_or_meta(device)),
            loss=_serving_only(cfg),
            prefill=lambda p, b, **kw: ds_m.prefill(p, b, cfg, **kw),
            decode=lambda p, t, c, n: ds_m.decode_step(p, t, c, n, cfg),
            init_cache=lambda batch, max_len, device=None: ds_m.init_latent_cache(
                cfg, batch, max_len, device=resolve_device_or_meta(device)),
            stitch=lambda cache, max_len: ds_m.stitch_latent_cache(cfg, cache, max_len),
            param_specs=lambda: ds_m.deepseek_v3_specs(cfg),
            cache_specs=ds_m.latent_cache_specs,
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
            param_specs=lambda: lstm_ae_specs(cfg),
        )
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {UNPORTED_FAMILIES[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Dry-run structs: meta tensors (a shape and a dtype, no storage), the
# counterpart of the reference's ShapeDtypeStruct
# ---------------------------------------------------------------------------

def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Model inputs for a given (arch x shape) dry-run cell.

    train/prefill: the token/series batch (+ modality stubs);
    decode: one token + cache_len (the cache itself comes from
    :func:`cache_struct`)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "lstm_ae":
        return {"series": _meta((b, s, cfg.lstm_ae.input_features), "float32")}

    if cfg.family == "whisper":
        if shape.kind == "train":
            return {
                "frames": _meta((b, cfg.encoder_seq_len, cfg.d_model), cfg.compute_dtype),
                "tokens": _meta((b, s), "int32"),
                "labels": _meta((b, s), "int32"),
            }
        if shape.kind == "prefill":
            return {
                "frames": _meta((b, cfg.encoder_seq_len, cfg.d_model), cfg.compute_dtype),
                "tokens": _meta((b, s), "int32"),
            }
        return {"token": _meta((b, 1), "int32"), "cache_len": _meta((), "int32")}

    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        p = cfg.vision_patches
        text = s - p
        if text <= 0:
            raise ValueError(f"{shape.name}: {s} positions leave no text after "
                             f"{p} image patches")
        spec = {
            "tokens": _meta((b, text), "int32"),
            "image_embeds": _meta((b, p, cfg.d_model), cfg.compute_dtype),
        }
        if shape.kind == "train":
            spec["labels"] = _meta((b, text), "int32")
        return spec

    if shape.kind == "train":
        return {"tokens": _meta((b, s), "int32"), "labels": _meta((b, s), "int32")}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, s), "int32")}
    return {"token": _meta((b, 1), "int32"), "cache_len": _meta((), "int32")}


def cache_struct(api: ModelAPI, batch: int, max_len: int) -> Params:
    """The decode cache as meta tensors: the family's own ``init_cache`` on
    the meta device (no allocation)."""
    return api.init_cache(batch, max_len, device="meta")


def param_struct(api: ModelAPI) -> Params:
    """The parameters as meta tensors: the family's own ``init`` on the meta
    device from a CPU generator, which draws nothing (no allocation)."""
    return api.init(torch.Generator().manual_seed(0), device="meta")
