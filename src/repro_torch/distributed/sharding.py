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

import torch

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


def fit_placements(placements: Sequence, shape: Sequence[int], mesh) -> tuple:
    """``placements`` with each ``Shard`` replicated whose dim the mesh
    axes sharding it do not divide (or which ``shape`` lacks): the
    layout of ``shape`` every rank holds an equal block of."""
    from torch.distributed.tensor import Replicate, Shard

    over = _shards_per_dim(placements, mesh)
    bad = {d for d, n in over.items() if d >= len(shape) or shape[d] % n}
    return tuple(Replicate() if isinstance(p, Shard) and p.dim in bad else p
                 for p in placements)


def _shards_per_dim(placements: Sequence, mesh) -> dict:
    """{tensor dim: the number of blocks the mesh axes sharding it cut it into}."""
    from torch.distributed.tensor import Shard

    over: dict[int, int] = {}
    for p, size in zip(placements, mesh.shape):
        if isinstance(p, Shard):
            over[p.dim] = over.get(p.dim, 1) * int(size)
    return over


def _uneven_dims(x, parts: dict) -> set:
    """The dims of DTensor ``x`` sharded into a number of blocks that does
    not divide ``parts[dim]``."""
    over = _shards_per_dim(x.placements, x.device_mesh)
    return {d for d, n in parts.items() if n % over.get(d, 1)}


def _replicated_dims(x, dims):
    from torch.distributed.tensor import Replicate, Shard

    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim in dims else p for p in x.placements))


def replicate_uneven(x, dim: int, n: int):
    """``x`` with tensor dim ``dim`` gathered (``Replicate``) where it is
    sharded over mesh axes whose sizes multiply to a number that does not
    divide ``n`` (a batch of 1 over a data axis of 16, before a product
    that merges it with the heads).  ``x`` itself if it is not a DTensor
    or the axes divide ``n``."""
    if not hasattr(x, "placements") or not _uneven_dims(x, {dim: n}):
        return x
    return _replicated_dims(x, {dim})


class _ReshapeGathered(torch.autograd.Function):
    """``x.reshape(shape)`` with ``dims`` of ``x`` gathered first; in the
    backward the grad's reshaped dims are gathered before the inverse
    reshape (DTensor refuses it on an uneven shard too), and the grad is
    then laid out as ``x`` was."""

    @staticmethod
    def forward(ctx, x, shape, dims):
        ctx.in_shape, ctx.in_placements = tuple(x.shape), tuple(x.placements)
        ctx.first = next((i for i, (a, b) in enumerate(zip(ctx.in_shape, shape)) if a != b),
                         min(len(ctx.in_shape), len(shape)))
        return _replicated_dims(x, dims).reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        dims = {d for d in range(ctx.first, grad.ndim)}
        whole = _replicated_dims(grad, dims).reshape(ctx.in_shape)
        # in x's own layout: the product that made x takes its grad sharded
        return whole.redistribute(whole.device_mesh, ctx.in_placements), None, None


def reshape_uneven(x, shape, parts: dict):
    """``x.reshape(shape)``, where each dim ``d`` of ``parts`` is split into
    or merged from ``parts[d]`` parts (heads, tokens).  Under a mesh whose
    axes do not divide those parts (4 kv heads over a model axis of 16),
    those dims are gathered first, forward and backward: DTensor refuses
    to reshape an uneven shard, where XLA's partitioner reshards it.
    Without a mesh, or where the axes divide, the plain reshape."""
    if not hasattr(x, "placements"):
        return x.reshape(shape)
    dims = _uneven_dims(x, parts)
    if not dims:
        return x.reshape(shape)
    return _ReshapeGathered.apply(x, tuple(shape), dims)


def padded_count(n: int, logical: str) -> int:
    """``n`` rounded up to a multiple of the size of the mesh axes that
    ``logical`` names under the installed mesh (24 heads over a model axis
    of 16: 32), as XLA pads an uneven shard; ``n`` itself without a mesh."""
    ctx = _current()
    if ctx is None:
        return n
    axes = ctx.rules.physical(logical)
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    size = 1
    for a in axes:
        size *= axis_size(ctx.mesh, a)
    return -(-n // size) * size


def pad_last(x, n: int):
    """``x`` with ``n`` zeros appended to its last dim: ``F.pad`` on a plain
    tensor, a ``cat`` of zeros on a DTensor (torch 2.11's ``F.pad`` gives a
    DTensor a one-placement spec on a 2-D mesh)."""
    if not hasattr(x, "placements"):
        return torch.nn.functional.pad(x, (0, n))
    if n == 0:
        return x
    return torch.cat([x, x.new_zeros(tuple(x.shape[:-1]) + (n,))], dim=-1)


def gather_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered (``Replicate``) where it is a
    DTensor sharded on it, as one differentiable redistribution whose
    backward hands the grad back in ``x``'s layout.  Before the split of a
    sharded dim into blocks (an LSTM's four gates): DTensor gathers it
    for the split either way, but inside the op, so that the product that
    made ``x`` would take a whole grad and compute its weight's grad
    whole on each rank.  ``x`` itself otherwise."""
    if not hasattr(x, "placements"):
        return x
    return _replicated_dims(x, {dim % x.ndim})


def lay_out(x, logical_axes, even: bool = True, like=None):
    """``x`` under the installed mesh in the layout of ``logical_axes``:
    where the reference leaves a tensor's layout to XLA's sharding
    propagation and DTensor's would replicate it (zero carries, weights
    stacked from sharded ones).  ``even`` replicates the dims the mesh
    axes do not divide; otherwise such a dim is sharded unevenly, as XLA
    pads it.  Not one of the reference's ``constrain`` sites.  ``x``
    itself without a mesh, and where neither ``x`` nor ``like`` is a
    DTensor (a computation on plain tensors under a mesh stays plain)."""
    ctx = _current()
    if ctx is None or not (hasattr(x, "placements") or hasattr(like, "placements")):
        return x
    placements = named_sharding(ctx.mesh, ctx.rules, logical_axes)
    if even:
        placements = fit_placements(placements, x.shape, ctx.mesh)
    return to_placements(x, ctx.mesh, placements)


def gather_for_columns(x, w):
    """``x`` as a product with the column-sharded weight ``w`` reads it:
    where ``x`` shards a leading dim (the sequence) over a mesh axis that
    shards ``w``'s output columns, that dim gathered (the sequence- to
    tensor-parallel all-gather), as XLA's partitioner reshards it.  On
    DTensor's own plan the product flattens a batch over data with a
    sequence over the model axis into a strided shard, planned from index
    lists as long as the tokens.  ``x`` itself otherwise."""
    if not (hasattr(x, "placements") and hasattr(w, "placements")):
        return x
    from torch.distributed.tensor import Replicate, Shard

    out_dim = w.ndim - 1
    cols = {i for i, p in enumerate(w.placements) if isinstance(p, Shard) and p.dim == out_dim}
    lead = [i for i, p in enumerate(x.placements)
            if i in cols and isinstance(p, Shard) and p.dim < x.ndim - 1]
    if not lead:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if i in lead else p for i, p in enumerate(x.placements)))


def gather_fsdp(w):
    """A weight as a product reads it: a DTensor under the installed mesh
    with its ``fsdp`` mesh axes gathered (``Replicate``), the rest of its
    layout kept, as FSDP and XLA's partitioner all-gather an fsdp-sharded
    weight before its product.  Without the gather DTensor may keep the
    weight's shards and reshard the activations instead, replicating the
    batch over the fsdp axis, so that each rank computes the product of
    the whole batch.  ``w`` itself otherwise."""
    ctx = _current()
    if ctx is None or not hasattr(w, "placements"):
        return w
    from torch.distributed.tensor import Replicate, Shard

    fsdp = ctx.rules.fsdp
    fsdp = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp or ())
    names = axis_names(ctx.mesh)
    placements = tuple(Replicate() if names[i] in fsdp and isinstance(p, Shard) else p
                       for i, p in enumerate(w.placements))
    return to_placements(w, ctx.mesh, placements)


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
    "axis_size", "constrain", "device_put", "fit_placements", "gather_dim",
    "gather_for_columns", "gather_fsdp", "is_placements", "is_spec_leaf", "lay_out",
    "map_specs", "mesh_context", "named_sharding", "pad_last", "padded_count",
    "placements_of", "recompute_context", "replicate_uneven", "replicated",
    "reshape_uneven", "rules_for_mesh", "spec_tree_to_shardings", "to_placements",
]
