"""Fault tolerance for long-running training (``repro/distributed``).

The heartbeat monitor and the recovery loop are ported; the sharding
rules wait for several GPUs (``ROADMAP.md``, queue 1, item 11g).
"""
from repro_torch.distributed.fault import (
    FailureInjector,
    HeartbeatMonitor,
    SimulatedFailure,
    run_with_recovery,
)

__all__ = [
    "FailureInjector",
    "HeartbeatMonitor",
    "SimulatedFailure",
    "run_with_recovery",
]
