"""The train step: autograd + AdamW, with optional microbatch gradient
accumulation and int8 + error-feedback gradient compression.

Counterpart of ``repro/training/step.py``.  The reference differentiates
with ``jax.value_and_grad`` through plain JAX ops (no kernel, no
``custom_vjp``); here autograd runs through plain PyTorch ops on the
params' device.  It takes the LSTM-AE's tree (tuples of layers) and the
LM's (stacked layer leaves, a tied table read twice) alike: grads come
back per leaf, accumulated in f32 over ``microbatch`` row blocks and
compressed per leaf under ``int8_ef``.

With a ``mesh`` (a torch ``DeviceMesh``) the step runs under
``mesh_context``, as the reference's: the model's ``constrain`` sites lay
activations out by the rules, on a state of DTensors placed by
:func:`train_state_specs` (``distributed.sharding.device_put``) and a batch
every rank holds whole.  DTensor hands a grad back in its own layout (a
weight placed ``(Shard, Shard)`` may come back ``(Partial, Replicate)``),
where the reference pins grads and the new state by ``out_shardings``;
here each grad is redistributed to its parameter's placements before
the update, so AdamW's moments keep the parameters' layout.  The loss is
taken whole before the backward, and the global reductions (the grad
norm, the int8 scale, the mean over microbatches) are DTensor reductions
over every shard, made whole where they are read.  Metrics come back as
plain 0-d tensors on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.config.core import TrainConfig
from repro_torch.distributed.sharding import mesh_context, rules_for_mesh, to_placements
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


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor (a collective every rank
    joins); a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def build_train_step(api: Any, tc: TrainConfig, mesh=None, rules=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``api`` is a ``ModelAPI`` (``repro_torch.models.build_model``), or any
    object whose ``loss(params, batch, **kw)`` returns ``(loss, metrics)``;
    it is called with the reference's ``remat`` and ``loss_chunk``
    keywords.  Metrics come back as 0-d tensors.  ``mesh`` and ``rules``
    as the reference's (rules default to ``rules_for_mesh(mesh)``)."""
    rules = rules or (rules_for_mesh(mesh) if mesh is not None else None)
    loss_kwargs = dict(remat=(tc.remat != "none"), loss_chunk=tc.loss_chunk)

    def grads_of(params: Params, batch: dict) -> tuple[Params, dict]:
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves: list = []
        tree_map(leaves.append, tracked)
        with torch.enable_grad():
            loss, metrics = api.loss(tracked, batch, **loss_kwargs)
            loss = _whole(loss)
            grads = iter(torch.autograd.grad(loss, leaves))
        metrics = {k: _whole(v).detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        if mesh is None:
            return tree_map(lambda _: next(grads), tracked), metrics
        # each grad in its parameter's layout (DTensor returns its own)
        return tree_map(lambda p: to_placements(next(grads), mesh, p.placements)
                        if hasattr(p, "placements") else next(grads), tracked), metrics

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        with mesh_context(mesh, rules):
            return _step(state, batch)

    def _step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if tc.microbatch > 1:
            g_sum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
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
        metrics.update({k: _whole(v) for k, v in opt_metrics.items()})
        return TrainState(params=new_params, opt=new_opt, ef=ef), metrics

    return train_step

