"""Logical-axis sharding: one vocabulary for layers, resolved per mesh.

Counterpart of ``repro/distributed/sharding.py``.  Parameters, caches
and optimizer states carry *logical* spec trees (each leaf a tuple of
logical axis names, one per dim: ``("fsdp", "tp")``); a
:class:`ShardingRules` maps logical names to physical mesh axes.  The
trees are pure Python and equal the reference's leaf for leaf
(``tests/test_torch_sharding.py``).

Logical axes
------------
``batch``   data-parallel batch dim            -> ("pod", "data") / ("data",)
``sp``      sequence-parallel residual stream  -> "model"
``tp``      tensor-parallel (heads/ffn/vocab)  -> "model"
``expert``  expert-parallel MoE dim            -> "model"
``fsdp``    fully-sharded parameter dim        -> "data"
``tokens``  flattened (batch*seq) token dim    -> ("data", "model")
``None``    replicated

Torch has no ``PartitionSpec``: :meth:`ShardingRules.spec` returns the
tuple of physical axes, which equals ``tuple(P(...))`` of the reference.
Placing tensors by these specs (DTensor placements over a
``torch.distributed`` device mesh: ``named_sharding``,
``spec_tree_to_shardings``, ``replicated``) and :func:`constrain` under an
installed mesh come with the sharded step (``ROADMAP.md``, queue 1, item
11g-2); until then :func:`constrain` checks the rank and is a no-op
without a mesh, and raises with one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Optional, Sequence

if TYPE_CHECKING:
    from repro_torch.engine.placement import DeviceMesh

SHARDED_STEP_ITEM = "ROADMAP.md, queue 1, item 11g-2 (the sharded step)"


@dataclass(frozen=True)
class ShardingRules:
    """Logical name -> physical mesh axis (or tuple of axes)."""
    batch: Any = ("data",)
    sp: Any = "model"
    tp: Any = "model"
    expert: Any = "model"
    fsdp: Any = "data"
    tokens: Any = ("data", "model")  # flattened (batch*seq) token dim

    def physical(self, logical: Optional[str]):
        if logical is None:
            return None
        try:
            return getattr(self, logical)
        except AttributeError:
            raise KeyError(f"unknown logical axis {logical!r}") from None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> tuple:
        """The physical axes of each dim, as ``tuple(PartitionSpec(...))``
        gives them: a dim over one mesh axis names it bare (``("data",)``
        -> ``"data"``), over none is None, over several a tuple."""
        return tuple(_canonical(self.physical(a)) for a in logical_axes)


def _canonical(axes):
    """One dim's physical axes in PartitionSpec's normal form."""
    if isinstance(axes, (tuple, list)):
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)
    return axes


def rules_for_mesh(mesh: DeviceMesh) -> ShardingRules:
    """Default rules: batch over (pod, data) when a pod axis exists."""
    if "pod" in mesh.axis_names:
        return ShardingRules(batch=("pod", "data"), tokens=("pod", "data", "model"))
    return ShardingRules()


@dataclass
class ActiveMesh:
    mesh: DeviceMesh
    rules: ShardingRules


_STATE = threading.local()


def _current() -> Optional[ActiveMesh]:
    return getattr(_STATE, "active", None)


@contextlib.contextmanager
def mesh_context(mesh: Optional[DeviceMesh], rules: Optional[ShardingRules] = None):
    """Install the mesh for :func:`constrain`; ``None`` disables constraints."""
    prev = _current()
    if mesh is None:
        _STATE.active = None
    else:
        _STATE.active = ActiveMesh(mesh, rules or rules_for_mesh(mesh))
    try:
        yield
    finally:
        _STATE.active = prev


def active_mesh() -> Optional[DeviceMesh]:
    ctx = _current()
    return ctx.mesh if ctx else None


def active_rules() -> Optional[ShardingRules]:
    ctx = _current()
    return ctx.rules if ctx else None


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """The reference's ``with_sharding_constraint`` by logical names: ``x``
    itself without a mesh; a spec of the wrong rank raises ``ValueError``
    as the reference's does.  Under an installed mesh it raises: placing
    tensors comes with the sharded step."""
    ctx = _current()
    if ctx is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"spec {logical_axes} does not match rank-{x.ndim} array")
    raise NotImplementedError(
        f"constrain under a mesh places tensors by "
        f"{ctx.rules.spec(logical_axes)}: {SHARDED_STEP_ITEM}")


def is_spec_leaf(v) -> bool:
    """A logical-axis spec is a tuple of None/str (e.g. ("tp", None)).
    Tuples holding dicts/sub-trees are containers, not specs."""
    return isinstance(v, tuple) and all(e is None or isinstance(e, str) for e in v)


def map_specs(fn, spec_tree):
    """``fn`` over the spec leaves of ``spec_tree``, same containers.

    The reference's ``jax.tree.map(fn, tree, is_leaf=is_spec_leaf)``: a
    tuple of str/None is a leaf (the empty tuple too); a dict, list, other
    tuple or dataclass instance (``AdamWState``, ``TrainState``) a
    container; and None an empty subtree left as it is."""
    if is_spec_leaf(spec_tree):
        return fn(spec_tree)
    if spec_tree is None:
        return None
    if dataclasses.is_dataclass(spec_tree) and not isinstance(spec_tree, type):
        return dataclasses.replace(spec_tree, **{
            f.name: map_specs(fn, getattr(spec_tree, f.name))
            for f in dataclasses.fields(spec_tree) if f.init})
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (tuple, list)):
        return type(spec_tree)(map_specs(fn, v) for v in spec_tree)
    return fn(spec_tree)


__all__ = [
    "ActiveMesh", "ShardingRules", "active_mesh", "active_rules", "constrain",
    "is_spec_leaf", "map_specs", "mesh_context", "rules_for_mesh",
]
