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
The reference's ``NamedSharding`` is a DTensor placement tuple over a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
(``named_sharding``): mesh dim *i* is ``Shard(d)`` where tensor dim *d*
names mesh axis *i*, else ``Replicate()`` (so too on an axis of size 1,
which holds the whole dim either way).  A dim over several axes
(``batch`` -> ``("pod", "data")``) shards in mesh order, DTensor's nested
``Shard``; axes listed out of mesh order, or one axis named twice, raise.
:func:`constrain` is ``with_sharding_constraint``: under an installed
mesh it redistributes a DTensor to its placements, and takes a plain
tensor as replicated (every rank computed it alike).  Without a mesh it
returns ``x`` itself.  A torch mesh installed by :func:`mesh_context`
also turns on DTensor's implicit replication, so the plain tensors a
layer makes (positions, masks, zeros) mix with DTensors as replicated.
The installed mesh is per thread, and autograd runs a CUDA backward on a
thread of its own: a layer recomputed there (``torch.utils.checkpoint``)
takes the forward's mesh through :func:`recompute_context`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Optional, Sequence

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


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


def axis_names(mesh) -> tuple[str, ...]:
    """A mesh's axis names: a torch ``DeviceMesh``'s ``mesh_dim_names``, or
    the engine's ``DeviceMesh.axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (the reference's ``mesh.shape[name]``)."""
    return int(mesh.shape[axis_names(mesh).index(name)])


def rules_for_mesh(mesh: DeviceMesh) -> ShardingRules:
    """Default rules: batch over (pod, data) when a pod axis exists."""
    if "pod" in axis_names(mesh):
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
    """Install the mesh for :func:`constrain`; ``None`` disables constraints.
    A torch ``DeviceMesh`` also turns on DTensor's implicit replication."""
    prev = _current()
    with contextlib.ExitStack() as stack:
        if mesh is None:
            _STATE.active = None
        else:
            _STATE.active = ActiveMesh(mesh, rules or rules_for_mesh(mesh))
            if hasattr(mesh, "mesh_dim_names"):
                stack.enter_context(_implicit_replication())
        try:
            yield
        finally:
            _STATE.active = prev


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's implicit replication, left on exit as it was: torch's own
    context manager turns it off on exit, also inside an outer one (a
    recompute on autograd's thread inside the step's context)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint``: (the forward's context,
    the recompute's), the recompute under the mesh the forward ran under.
    A CUDA backward runs on autograd's own thread, where this thread's
    mesh is not installed; without the mesh the recompute would take
    other paths (``apply_moe`` for ``apply_moe_ep``, ``WKV6`` on DTensors
    for ``local_map``) than the forward."""
    ctx = _current()
    if ctx is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), mesh_context(ctx.mesh, ctx.rules)


def active_mesh() -> Optional[DeviceMesh]:
    ctx = _current()
    return ctx.mesh if ctx else None


def active_rules() -> Optional[ShardingRules]:
    ctx = _current()
    return ctx.rules if ctx else None


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """``with_sharding_constraint`` by logical names; ``x`` itself without a
    mesh.  A spec of the wrong rank raises ``ValueError`` as the
    reference's does.  Under a mesh, ``x`` (a DTensor, or a plain tensor
    taken as replicated) redistributed to the spec's placements; both
    directions are differentiable."""
    ctx = _current()
    if ctx is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"spec {logical_axes} does not match rank-{x.ndim} array")
    return to_placements(x, ctx.mesh, named_sharding(ctx.mesh, ctx.rules, logical_axes))


def placements_of(mesh, spec: Sequence) -> tuple:
    """The DTensor placements of a physical spec (``ShardingRules.spec``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    placements: list = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, not one of the "
                                 f"mesh's {names}")
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {tuple(spec)} lists axes {axes} out of the mesh's "
                             f"order {names}: DTensor cannot place that")
        for i in order:
            if isinstance(placements[i], Shard):
                raise ValueError(f"spec {tuple(spec)} names mesh axis {names[i]!r} twice")
            placements[i] = Shard(dim)
    # an axis of size 1 holds the whole dim: the same layout as Replicate,
    # which DTensor's strategies handle where a Shard of a size-1 dim over
    # it may not (a matmul on (B, 1, D) sharded (batch, sp) at decode)
    return tuple(Replicate() if int(n) == 1 else p for p, n in zip(placements, mesh.shape))


def named_sharding(mesh: DeviceMesh, rules: ShardingRules, logical_axes) -> tuple:
    """The DTensor placements of a logical spec on ``mesh``."""
    return placements_of(mesh, rules.spec(logical_axes))


def replicated(mesh: DeviceMesh) -> tuple:
    """Every mesh dim ``Replicate()`` (the reference's ``NamedSharding(mesh, P())``)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * len(axis_names(mesh))


def to_placements(x, mesh: DeviceMesh, placements: Sequence):
    """``x`` as a DTensor on ``mesh`` with ``placements``: a DTensor is
    redistributed, a plain tensor taken as replicated first."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, replicated(mesh), run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, tuple(placements))


def is_placements(v) -> bool:
    """A leaf of :func:`spec_tree_to_shardings`' tree: a tuple of placements."""
    from torch.distributed.tensor import Placement

    return isinstance(v, tuple) and bool(v) and all(isinstance(p, Placement) for p in v)


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


def spec_tree_to_shardings(mesh: DeviceMesh, rules: ShardingRules, spec_tree):
    """Map a tree of logical-axis tuples to DTensor placement tuples."""
    return map_specs(lambda axes: named_sharding(mesh, rules, axes), spec_tree)


def device_put(tree, mesh: DeviceMesh, shardings):
    """``jax.device_put(tree, shardings)``: each tensor leaf of ``tree``
    placed by its placement tuple in ``shardings`` (the same containers;
    a leaf ``None`` stays None).  A DTensor is redistributed; a plain
    tensor, which every rank holds whole, is distributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(x, placements):
        if isinstance(x, DTensor):
            return to_placements(x, mesh, placements)
        return distribute_tensor(x, mesh, placements)

    return _zip_shardings(put, tree, shardings)


def _zip_shardings(fn, tree, shardings):
    if tree is None:
        return None
    if is_placements(shardings):
        return fn(tree, shardings)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _zip_shardings(fn, getattr(tree, f.name), getattr(shardings, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _zip_shardings(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_shardings(fn, v, s) for v, s in zip(tree, shardings, strict=True))
    raise TypeError(f"no placements for leaf of type {type(tree).__name__}: {shardings!r}")


__all__ = [
    "ActiveMesh", "ShardingRules", "active_mesh", "active_rules", "axis_names",
    "axis_size", "constrain", "device_put", "is_placements", "is_spec_leaf", "map_specs",
    "mesh_context", "named_sharding", "placements_of", "recompute_context", "replicated",
    "rules_for_mesh",
    "spec_tree_to_shardings", "to_placements",
]
