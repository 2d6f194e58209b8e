"""Checkpoints in the reference's format (``repro/checkpoint``), without JAX."""
from repro_torch.checkpoint.manager import (
    AsyncCheckpointer,
    latest_checkpoint,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "AsyncCheckpointer",
    "latest_checkpoint",
    "list_checkpoints",
    "restore_checkpoint",
    "save_checkpoint",
]
