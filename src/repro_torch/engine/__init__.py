"""Execution engine of the port: schedule registry, Placement, Engine, AnomalyService."""
from repro_torch.engine.base import Engine, EngineConfig, build_engine
from repro_torch.engine.placement import Placement
from repro_torch.engine.schedules import (
    Schedule,
    available_schedules,
    register_schedule,
    resolve_schedule,
    schedule_cache_info,
    unregister_schedule,
)
from repro_torch.engine.service import AnomalyService, StreamSession

__all__ = [
    "AnomalyService",
    "Engine",
    "EngineConfig",
    "Placement",
    "Schedule",
    "StreamSession",
    "available_schedules",
    "build_engine",
    "register_schedule",
    "resolve_schedule",
    "schedule_cache_info",
    "unregister_schedule",
]
