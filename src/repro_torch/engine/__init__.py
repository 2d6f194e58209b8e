"""Execution engine of the port: schedule registry, Engine, AnomalyService."""
from repro_torch.engine.base import Engine, EngineConfig, build_engine
from repro_torch.engine.schedules import (
    Schedule,
    available_schedules,
    register_schedule,
    resolve_schedule,
    unregister_schedule,
)
from repro_torch.engine.service import AnomalyService, StreamSession

__all__ = [
    "AnomalyService",
    "Engine",
    "EngineConfig",
    "Schedule",
    "StreamSession",
    "available_schedules",
    "build_engine",
    "register_schedule",
    "resolve_schedule",
    "unregister_schedule",
]
