"""Parameter helpers: initialisation, the weight carrier to and from numpy,
and walks over parameter trees.

Parameters are plain nested containers of tensors, in the JAX package's
layout: ``{"layers": ({"wx": (In, 4H), "wh": (H, 4H), "b": (4H,)}, ...)}``.
"""
from __future__ import annotations

import math
from typing import Any, Union

import numpy as np
import torch

from repro_torch import resolve_device

Params = Any  # nested dict / tuple / list of tensors


def truncated_normal_init(
    shape: tuple[int, ...], fan_in: int | None = None,
    generator: torch.Generator | None = None, device=None,
) -> torch.Tensor:
    """He-style truncated normal (std = 1/sqrt(fan_in), cut at 2 std), drawn
    on ``device`` (default: the CPU) from ``generator``, which must live on
    that device.

    The distribution of ``repro.utils.truncated_normal_init``; the values
    differ, because ``torch.Generator`` and ``jax.random`` draw other bits."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
    std = 1.0 / math.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std)


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); returns a tree of the same containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> list:
    """The leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted,
    sequences in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree: Params, device: Union[str, torch.device, None] = None) -> Params:
    """Numpy arrays (e.g. ``np.asarray`` of the JAX package's params) or
    tensors -> tensors on ``device``, same containers and dtypes.  Arrays
    are copied, so the tensors never share memory with the caller's arrays."""
    dev = resolve_device(device)

    def leaf(a):
        return a.to(dev) if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a)).to(dev)

    return tree_map(leaf, tree)


def params_to_numpy(tree: Params) -> Params:
    """Tensors (or arrays) -> numpy arrays on the host, same containers."""
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t), tree)
