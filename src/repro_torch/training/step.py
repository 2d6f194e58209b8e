"""The train step: autograd + AdamW, with optional microbatch gradient
accumulation and int8 + error-feedback gradient compression.

Counterpart of ``repro/training/step.py``.  The reference differentiates
with ``jax.value_and_grad`` through plain JAX ops (no kernel, no
``custom_vjp``); here autograd runs through plain PyTorch ops on the
params' device.  It takes the LSTM-AE's tree (tuples of layers) and the
LM's (stacked layer leaves, a tied table read twice) alike: grads come
back per leaf, accumulated in f32 over ``microbatch`` row blocks and
compressed per leaf under ``int8_ef``.  The step is eager and unsharded:
a ``mesh`` or sharding ``rules`` raise.  The reference shards its step
only over a mesh that ``launch/train.py::pick_mesh`` builds at 256
devices or more.  The port has the rules and the state's spec tree
(``distributed/sharding.py``, :func:`train_state_specs`); placing the
state by them is the sharded step (``ROADMAP.md``, queue 1, item 11g-2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.config.core import TrainConfig
from repro_torch.optim import (
    AdamWState,
    adamw_update,
    compress_grads,
    init_error_feedback,
    init_opt_state,
    opt_state_specs,
)
from repro_torch.utils import Params, tree_map


@dataclass(frozen=True)
class TrainState:
    params: Params
    opt: AdamWState
    ef: Optional[Params]  # error-feedback buffers (grad compression) or None


def init_train_state(params: Params, tc: TrainConfig) -> TrainState:
    """A train state over ``params`` (the reference draws them from a JAX
    key inside; torch cannot draw those bits, so the caller passes them)."""
    return TrainState(
        params=params,
        opt=init_opt_state(params),
        ef=init_error_feedback(params) if tc.grad_compression == "int8_ef" else None,
    )


def train_state_specs(api: Any, tc: TrainConfig) -> TrainState:
    """The logical-axis spec tree of :func:`init_train_state`'s state."""
    ps = api.param_specs()
    return TrainState(
        params=ps,
        opt=opt_state_specs(ps),
        ef=ps if tc.grad_compression == "int8_ef" else None,
    )


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of contiguous row blocks, as the reference's
    reshape to (n, B/n, ...) splits them."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatch {n}")
        return x.reshape(n, b // n, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def build_train_step(api: Any, tc: TrainConfig, mesh=None, rules=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``api`` is a ``ModelAPI`` (``repro_torch.models.build_model``), or any
    object whose ``loss(params, batch, **kw)`` returns ``(loss, metrics)``;
    it is called with the reference's ``remat`` and ``loss_chunk``
    keywords.  Metrics come back as 0-d tensors."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "a train step over a mesh or sharding rules is not ported yet: it "
            "is the sharded step, ROADMAP.md, queue 1, item 11g-2 (the "
            "reference builds a training mesh only at 256 devices)")
    loss_kwargs = dict(remat=(tc.remat != "none"), loss_chunk=tc.loss_chunk)

    def grads_of(params: Params, batch: dict) -> tuple[Params, dict]:
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves: list = []
        tree_map(leaves.append, tracked)
        with torch.enable_grad():
            loss, metrics = api.loss(tracked, batch, **loss_kwargs)
            grads = iter(torch.autograd.grad(loss, leaves))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return tree_map(lambda _: next(grads), tracked), metrics

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if tc.microbatch > 1:
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            ms = []
            for mb in _split_microbatches(batch, tc.microbatch):
                g, m = grads_of(state.params, mb)
                g_sum = tree_map(lambda a, b: a + b.float(), g_sum, g)
                ms.append(m)
            grads = tree_map(lambda g: g / tc.microbatch, g_sum)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(dim=0) for k in ms[0]}
        else:
            grads, metrics = grads_of(state.params, batch)

        ef = state.ef
        if tc.grad_compression == "int8_ef":
            grads, ef = compress_grads(grads, ef)

        new_params, new_opt, opt_metrics = adamw_update(state.params, grads, state.opt, tc)
        metrics.update(opt_metrics)
        return TrainState(params=new_params, opt=new_opt, ef=ef), metrics

    return train_step

