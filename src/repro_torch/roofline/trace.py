"""Per-op cost record of a traced step: the counterpart of ``repro/roofline/hlo_cost.py``.

The reference compiles a cell and re-derives its costs from the
partitioned HLO text, one device's program.  The port runs the step
eagerly on meta tensors (shapes and dtypes, no storage) under
:class:`OpTrace`, a ``TorchDispatchMode`` that records each aten op rank 0
issues, on its **local** shapes: an op on DTensors is handed on to
DTensor (the mode returns ``NotImplemented``), which redistributes its
operands and runs the local op on each shard, and the mode records that
local op and the collectives of the redistribution.  The ops DTensor's
sharding propagation runs on fake tensors (global shapes, to infer the
output's) are not recorded.

The record is a list of entries (op, local inputs and outputs as shapes
and dtypes with the op's other arguments, count).  :func:`analyze` turns
it into the three roofline quantities, per chip:

* flops            — dots only, as the reference counts: matmul, bmm,
                     baddbmm, convolution and the kernels' meta ops
                     (``kernels/meta.py``), through
                     ``torch.utils.flop_counter``'s formulas, by the dtype
                     of the op's first output.
* bytes            — operands plus outputs per op.  Views, metadata ops
                     and allocations are free (the reference's
                     ``_FREE_OPS``); an in-place update of a slice
                     (``copy_``, ``index_put_``, ``index_copy_``,
                     ``index_add_``, ``scatter_``) counts the update read
                     and written, as the reference counts
                     ``dynamic-update-slice``.
* collective bytes — each ``_c10d_functional`` collective's input payload,
                     by kind (all-gather, all-reduce, reduce-scatter,
                     all-to-all, the reference's names); also counted in
                     bytes, payload plus output, as the reference does.

Eager torch fuses nothing, so its bytes are those of unfused ops; the
reference's are XLA's after fusion.  Bytes and collective bytes are
reported beside the reference's, never held to them.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops that move no bytes: allocation, metadata, and the collectives' plumbing
_FREE_OPS = {
    "aten.empty.memory_format", "aten.empty_strided.default", "aten.empty_like.default",
    "aten.new_empty.default", "aten.new_empty_strided.default", "aten.lift_fresh.default",
    "aten.detach.default", "aten._unsafe_view.default", "aten.sym_size.int", "aten.sym_stride.int", "aten.sym_numel.default",
    "aten.sym_storage_offset.default", "aten.is_same_size.default", "aten._local_scalar_dense.default",
    "aten.set_.source_Tensor", "aten.resize_.default",
    "_c10d_functional.wait_tensor.default", "_c10d_functional._wrap_tensor_autograd.default",
}
# in-place writes of a slice: the update is read and written, the buffer is not
_SLICE_UPDATES = {
    "aten.copy_.default", "aten.index_put_.default", "aten._index_put_impl_.default",
    "aten.index_copy_.default", "aten.index_add_.default", "aten.scatter_.src",
    "aten.scatter_.value", "aten.scatter_add_.default", "aten.scatter_reduce_.two",
    "aten.masked_scatter_.default",
}
_COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def collective_kind(op: str) -> Optional[str]:
    """The reference's name of a collective op ("all-gather", ...), or None."""
    ns, _, name = op.partition(".")
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    for kind in _COLLECTIVES:
        if name.startswith(kind):
            return kind.replace("_", "-")
    return None


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _encode(a):
    """An argument as a hashable, JSON-able value: a tensor as
    ("T", shape, dtype), a sequence as a tuple, anything else as itself or
    its string."""
    if isinstance(a, torch.Tensor):
        return ("T", tuple(int(d) for d in a.shape), str(a.dtype).removeprefix("torch."))
    if isinstance(a, (list, tuple)):
        return tuple(_encode(x) for x in a)
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    return str(a)


class OpTrace(TorchDispatchMode):
    """Record every aten op the step issues on this rank's local tensors:
    ``counts`` maps (op, args, kwargs, outputs), each encoded by
    :func:`_encode`, to how many times it ran.  Ops on DTensors pass to
    DTensor and are seen as the local ops it runs."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(_is_fake(a) for a in flat) or any(_is_fake(o) for o in tree_flatten(out)[0]):
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.counts[(str(func), _encode(args),
                     tuple((k, _encode(v)) for k, v in sorted(kwargs.items())),
                     tuple(_encode(o) for o in outs if isinstance(o, torch.Tensor)))] += 1
        return out

    def record(self) -> list[dict]:
        """The record: one entry per distinct op signature, with its count."""
        return [{"op": op, "args": _jsonable(a), "kwargs": {k: _jsonable(v) for k, v in kw},
                 "out": _jsonable(o), "n": n}
                for (op, a, kw, o), n in self.counts.items()]


def _jsonable(v):
    if isinstance(v, tuple) and len(v) == 3 and v[0] == "T":
        return {"shape": list(v[1]), "dtype": v[2]}
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return v


def _is_tensor(v) -> bool:
    return isinstance(v, dict) and set(v) == {"shape", "dtype"}


def _nbytes(v) -> int:
    """Bytes of every tensor inside an encoded argument."""
    if _is_tensor(v):
        n = 1
        for d in v["shape"]:
            n *= d
        return n * torch.empty((), dtype=getattr(torch, v["dtype"])).element_size()
    if isinstance(v, dict):
        return sum(_nbytes(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return 0


def _shapes(v):
    """An encoded argument with each tensor as its ``torch.Size`` (what the
    flop formulas read)."""
    if _is_tensor(v):
        return torch.Size(v["shape"])
    if isinstance(v, list):
        return [_shapes(x) for x in v]
    if isinstance(v, dict):
        return {k: _shapes(x) for k, x in v.items()}
    return v


def _packet(op: str):
    """The op overload packet of "ns.name.overload" (None if unknown)."""
    ns, name = op.split(".")[:2]
    try:
        return getattr(getattr(torch.ops, ns), name)
    except (AttributeError, RuntimeError):
        return None


def entry_flops(entry: dict) -> float:
    """Dot FLOPs of one run of an entry's op (0 for anything but a dot)."""
    from torch.utils.flop_counter import flop_registry

    packet = _packet(entry["op"])
    if packet is None or packet not in flop_registry:
        return 0.0
    outs = [_shapes(o) for o in entry["out"]]
    out_val = outs[0] if len(outs) == 1 else tuple(outs)
    return float(flop_registry[packet](*_shapes(entry["args"]), **_shapes(entry["kwargs"]),
                                       out_val=out_val))


def entry_bytes(entry: dict) -> float:
    """Bytes one run of an entry's op moves (see the module's docstring)."""
    op = entry["op"]
    if op in _FREE_OPS or _is_view(op):
        return 0.0
    if collective_kind(op):
        return float(_nbytes(entry["args"][:1]) + _nbytes(entry["out"]))
    if op in _SLICE_UPDATES:
        return 2.0 * _nbytes(entry["args"][1:]) + 2.0 * _nbytes(
            {k: v for k, v in entry["kwargs"].items() if k != "self"})
    return float(_nbytes(entry["args"]) + _nbytes(entry["kwargs"]) + _nbytes(entry["out"]))


def entry_dtype(entry: dict) -> str:
    """The dtype an entry's FLOPs are counted in: its first output's."""
    for o in entry["out"]:
        if _is_tensor(o):
            return o["dtype"]
    return "float32"


_VIEW_CACHE: dict[str, bool] = {}


def _is_view(op: str) -> bool:
    if op not in _VIEW_CACHE:
        packet = _packet(op)
        overload = op.split(".", 2)[2] if op.count(".") >= 2 else "default"
        ov = getattr(packet, overload, None) if packet is not None else None
        _VIEW_CACHE[op] = bool(getattr(ov, "is_view", False))
    return _VIEW_CACHE[op]


@dataclass
class CostTotals:
    """Per-chip totals of a record (the reference's ``CostTotals``), with the
    FLOPs also by dtype."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    flops_by_dtype: dict = field(default_factory=dict)
    coll_by_op: dict = field(default_factory=dict)
    coll_count: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)


def analyze(record: list[dict]) -> CostTotals:
    """The three roofline quantities of a record, per chip."""
    t = CostTotals()
    for e in record:
        n = e["n"]
        f = entry_flops(e) * n
        if f:
            t.flops += f
            dt = entry_dtype(e)
            t.flops_by_dtype[dt] = t.flops_by_dtype.get(dt, 0.0) + f
        t.bytes += entry_bytes(e) * n
        kind = collective_kind(e["op"])
        if kind:
            payload = _nbytes(e["args"][:1]) * n
            t.coll_bytes += payload
            t.coll_by_op[kind] = t.coll_by_op.get(kind, 0) + payload
            t.coll_count[kind] = t.coll_count.get(kind, 0) + n
    return t


def trace(fn, *args, **kwargs) -> tuple[Any, list[dict]]:
    """``fn(*args, **kwargs)`` under :class:`OpTrace`: (its result, the record)."""
    with OpTrace() as tr:
        out = fn(*args, **kwargs)
    return out, tr.record()


__all__ = ["CostTotals", "OpTrace", "analyze", "collective_kind", "entry_bytes",
           "entry_dtype", "entry_flops", "trace"]
