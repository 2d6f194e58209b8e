"""PyTorch + CUDA port of the temporal-parallel LSTM-AE system.

The package mirrors the JAX package ``repro`` module for module and is held
to it by ``tests/test_torch_*.py``.  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.

Every entry point takes ``device=`` and resolves it with
:func:`resolve_device`: the default is the GPU, and the CPU is used only
when the caller asks for it.  There is no silent CPU fallback.

Importing the package itself imports nothing heavy: its exports load on
first use, so the static-analysis gate (``python -m repro_torch.analysis``,
stdlib only) runs on an interpreter without torch or numpy.
"""
from __future__ import annotations

import importlib
from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device raises ``RuntimeError`` when
    no GPU is visible.  ``"cpu"`` is taken only when it is passed."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the "
                "CPU explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


# public exports -> the module that defines them, imported on first use
_EXPORTS = {
    "get_config": "repro_torch.config",
    "list_archs": "repro_torch.config",
    "reduced_config": "repro_torch.config",
    "AnomalyService": "repro_torch.engine",
    "Engine": "repro_torch.engine",
    "EngineConfig": "repro_torch.engine",
    "available_schedules": "repro_torch.engine",
    "build_engine": "repro_torch.engine",
    "params_from_numpy": "repro_torch.utils",
    "params_to_numpy": "repro_torch.utils",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")

__all__ = [
    "AnomalyService",
    "Engine",
    "EngineConfig",
    "available_schedules",
    "build_engine",
    "get_config",
    "list_archs",
    "params_from_numpy",
    "params_to_numpy",
    "reduced_config",
    "resolve_device",
]
