"""AdamW with decoupled weight decay, global-norm clipping, and a
warmup+cosine schedule, written out by hand.

Counterpart of ``repro/optim/adamw.py``, with its arithmetic: the schedule
in f32 from an int32 step, the clip over every leaf's f32 sum of squares,
``b ** step`` bias correction in f32, and weight decay added to the update
before the lr scale, on every leaf (biases too).  ``torch.optim.AdamW``
orders these differently, so it is not used.  States mirror the param tree
and live on the params' device; updates are functional (new tensors), so
a caller's params are never written.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.config.core import TrainConfig
from repro_torch.utils import Params, tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWState:
    step: torch.Tensor    # () int32
    mu: Params            # first moment (f32, param tree)
    nu: Params            # second moment (f32, param tree)


def init_opt_state(params: Params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``learning_rate``, then a cosine down to 0.1 of it,
    in f32 (``step`` an int32 tensor)."""
    warm = torch.clamp((step + 1) / max(1, tc.warmup_steps), max=1.0)
    progress = torch.clamp(
        (step - tc.warmup_steps) / max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(
    params: Params, grads: Params, state: AdamWState, tc: TrainConfig
) -> tuple[Params, AdamWState, dict]:
    grads = tree_map(lambda g: g.float(), grads)
    if tc.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_schedule(state.step, tc)
    b1, b2 = tc.beta1, tc.beta2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g), state.nu, grads)
    mu_hat_scale = 1.0 / (1 - torch.pow(b1, step.float()))
    nu_hat_scale = 1.0 / (1 - torch.pow(b2, step.float()))

    def upd(p, m, v):
        u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + tc.eps)
        u = u + tc.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step=step, mu=mu, nu=nu), {"grad_norm": gnorm, "lr": lr}
