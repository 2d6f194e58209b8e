"""PyTorch + CUDA port of the temporal-parallel LSTM-AE system.

The package mirrors the JAX package ``repro`` module for module and is held
to it by ``tests/test_torch_*.py``.  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.

Every entry point takes ``device=`` and resolves it with
:func:`resolve_device`: the default is the GPU, and the CPU is used only
when the caller asks for it.  There is no silent CPU fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device raises ``RuntimeError`` when
    no GPU is visible.  ``"cpu"`` is taken only when it is passed."""
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


# public exports (imported after resolve_device, which the modules use)
from repro_torch.config import get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    AnomalyService,
    Engine,
    EngineConfig,
    available_schedules,
    build_engine,
)
from repro_torch.utils import params_from_numpy, params_to_numpy  # noqa: E402

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
