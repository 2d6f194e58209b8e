"""Small device meshes for the pipeline and its tests.

Counterpart of ``make_host_mesh`` in ``repro/launch/mesh.py``, returning
the port's :class:`~repro_torch.engine.placement.DeviceMesh`.  A function,
never a module-level constant: importing this module touches no device.
The reference's ``make_production_mesh`` (16x16 and larger) comes with the
LM families (``ROADMAP.md``, queue 1, item 11g).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from repro_torch.engine.placement import DeviceMesh, make_mesh, visible_devices


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


__all__ = ["make_host_mesh"]
