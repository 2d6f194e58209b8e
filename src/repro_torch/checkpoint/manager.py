"""Checkpointing: atomic, async-capable, in the reference's on-disk format.

Counterpart of ``repro/checkpoint/manager.py``.  One directory per step
holds a flat ``leaves.npz`` of leaves keyed by tree path plus
``meta.json`` (step, keys, each leaf's saved dtype).  Writes go to
``<dir>.tmp`` then ``os.replace``, so a crash mid-save can never corrupt
the latest checkpoint.

The keys are the reference's: a leaf's path joined by ``/``, each part a
dict key, a sequence index or ``.field`` of a dataclass (a train state),
in the order ``jax.tree_util`` flattens (dict keys sorted, sequences and
dataclass fields in order).  So a checkpoint written by one
package restores in the other.  ``treedef`` in ``meta.json`` describes the
tree for a reader and is never parsed; restores follow the target's
structure.  Only whole, unsharded leaves are restored: restoring onto
sharded placements comes with the sharded train step (``ROADMAP.md``,
queue 1, item 11g-2).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils import Params

def _is_node(tree) -> bool:
    """A dataclass instance is a tree node (as ``register_dataclass``
    makes the reference's train state one), its fields in order."""
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _items(tree: Params, prefix: tuple = ()):
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path`` order:
    dict keys sorted, sequences in order, dataclass fields in order (as
    ``.name``); None is an empty subtree."""
    if _is_node(tree):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), prefix + (f".{f.name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _host(leaf) -> np.ndarray:
    """A host array of ``leaf``; bfloat16 becomes float32 (npz cannot hold
    it, and the upcast is exact)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _flatten(tree: Params) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """{path-key: host array} and {path-key: original dtype name}."""
    flat, dtypes = {}, {}
    for path, leaf in _items(tree):
        key = _key(path)
        dtypes[key] = _dtype_name(leaf)
        flat[key] = _host(leaf)
    return flat, dtypes


def _describe(tree: Params) -> str:
    """The tree's containers with ``*`` for each leaf, e.g.
    ``{'layers': ({'b': *, 'wh': *}, ...)}`` — informative only."""
    if _is_node(tree):
        return (type(tree).__name__ + "(" + ", ".join(
            f"{f.name}={_describe(getattr(tree, f.name))}" for f in dataclasses.fields(tree)) + ")")
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_describe(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _restored(arr: np.ndarray, name: Optional[str], target) -> torch.Tensor:
    """``arr`` as a tensor of its saved dtype ``name`` (the target's when
    the checkpoint predates the dtype map), on the target leaf's device."""
    if name is None:
        name = _dtype_name(target)
    if name == "bfloat16":   # stored as float32
        t = torch.from_numpy(np.array(arr, np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, dtype=np.dtype(name)))
    return t.to(target.device if isinstance(target, torch.Tensor) else "cpu")


def save_checkpoint(directory: str | Path, step: int, state: Params,
                    extra_meta: Optional[dict] = None) -> Path:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat, dtypes = _flatten(state)
    np.savez(tmp / "leaves.npz", **flat)
    meta = {
        "step": step,
        "num_leaves": len(flat),
        "keys": sorted(flat.keys()),
        "dtypes": dtypes,
        "treedef": _describe(state),
        **(extra_meta or {}),
    }
    (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncCheckpointer:
    """Background-thread checkpointing: copy to the host, save off-thread.

    ``save`` blocks only for the device-to-host copy of each leaf, on the
    caller's thread; serialisation happens on the worker thread, which
    never touches the device.  ``wait()`` joins outstanding saves (call
    before exit / before deleting old checkpoints).  ``last_write_ms`` is
    the serialise-and-rename time of the last save that completed, timed
    on the thread that wrote it (None before the first)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self.last_write_ms: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @property
    def busy(self) -> bool:
        """True while a background save is still in flight.  Callers on a
        latency-sensitive thread (the gateway pump) poll this to *skip* a
        snapshot tick instead of blocking in ``save`` -> ``wait``."""
        return self._thread is not None and self._thread.is_alive()

    def save(self, step: int, state: Params, extra_meta: Optional[dict] = None):
        self.wait()
        # a copy the caller cannot change under the writer: tensors to
        # the host now, on this thread; the worker thread only serialises
        host_state = _rebuild(state, {
            path: leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor) else leaf
            for path, leaf in _items(state)}, ())

        def _work():
            try:
                t0 = time.perf_counter()
                save_checkpoint(self.directory, step, host_state, extra_meta)
                self.last_write_ms = (time.perf_counter() - t0) * 1e3
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(list_checkpoints(self.directory))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)


def list_checkpoints(directory: str | Path) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    steps = list_checkpoints(directory)
    if not steps:
        return None
    return Path(directory) / f"step_{steps[-1]:08d}"


def restore_checkpoint(
    path: str | Path,
    target: Params,
    *,
    shardings: Any = None,
) -> tuple[Params, dict]:
    """Restore into the structure of ``target`` (a tree of tensors or
    arrays, whose shapes must match).  Each leaf comes back as a tensor of
    its saved dtype, on the target leaf's device (the CPU for an array).
    ``shardings`` (a placement per leaf) is refused until the sharded
    train step exists (``ROADMAP.md``, queue 1, item 11g-2)."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto sharded placements is not ported yet: it comes "
            "with the sharded train step, ROADMAP.md, queue 1, item 11g-2"
        )
    path = Path(path)
    with np.load(path / "leaves.npz") as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads((path / "meta.json").read_text())
    saved = meta.get("dtypes", {})
    leaves = {}
    for p, leaf in _items(target):
        key = _key(p)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs target {leaf.shape}")
        leaves[p] = _restored(arr, saved.get(key), leaf)
    return _rebuild(target, leaves, ()), meta


def _rebuild(tree: Params, leaves: dict, prefix: tuple) -> Params:
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves, prefix + (f".{f.name}",))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves, prefix + (i,)) for i, v in enumerate(tree))
    return None if tree is None else leaves[prefix]
