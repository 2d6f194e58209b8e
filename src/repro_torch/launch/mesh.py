"""Device meshes: the production mesh of the sharded step, and small
meshes for the pipeline and its tests.

Counterpart of ``repro/launch/mesh.py``.  ``make_production_mesh`` is a
torch ``DeviceMesh`` over the ranks of the process group (16x16
``("data", "model")``, or 2x16x16 with ``"pod"``: ``SINGLE_POD`` and
``MULTI_POD`` in ``repro_torch.config``); ``make_host_mesh`` returns the
port's :class:`~repro_torch.engine.placement.DeviceMesh` of devices in
one process.  Functions, never module-level constants: importing this
module touches no device and no process group.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from repro_torch.engine.placement import DeviceMesh, make_mesh, visible_devices


def world_size() -> int:
    """The process group's size; 1 when none is initialised."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 (data, model) single pod, or 2x16x16 (pod, data, model), over
    the first ranks of the process group, on ``device``'s type (the GPU by
    default; ``"cpu"`` for gloo).  A smaller group raises."""
    from torch.distributed.device_mesh import DeviceMesh as TorchMesh

    from repro_torch import resolve_device

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks but the process group has {have}; "
            "launch one process per device (torchrun) before building it")
    return TorchMesh(resolve_device(device).type, torch.arange(need).reshape(shape),
                     mesh_dim_names=axes)


def make_host_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                   devices: Optional[Sequence[Union[str, torch.device]]] = None) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes``, e.g. (1, 4) stages.

    ``devices`` (which may repeat a device: ``("cuda:0",) * 4`` runs four
    cells on one card, each on its own stream; ``("cpu",) * 4`` emulates
    four CPU devices) defaults to the visible GPUs; fewer than the mesh
    needs raise."""
    need = math.prod(shape)
    pool = visible_devices("cuda") if devices is None else tuple(devices)
    if len(pool) < need:
        raise RuntimeError(f"need {need} devices, have {len(pool)}; pass devices= "
                           f"(a device may repeat) to emulate them")
    return make_mesh(shape, axes, pool[:need])


__all__ = ["make_host_mesh", "make_production_mesh", "world_size"]
