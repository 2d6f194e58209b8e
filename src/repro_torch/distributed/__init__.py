"""Fault tolerance and sharding (``repro/distributed``).

The heartbeat monitor and the recovery loop, and the sharding rules,
spec-tree helpers and their DTensor placements over a ``torch.distributed``
device mesh (``sharding.py``).
"""
from repro_torch.distributed.fault import (
    FailureInjector,
    HeartbeatMonitor,
    SimulatedFailure,
    run_with_recovery,
)
from repro_torch.distributed.sharding import (
    ShardingRules,
    active_mesh,
    active_rules,
    constrain,
    is_spec_leaf,
    map_specs,
    mesh_context,
    rules_for_mesh,
    spec_tree_to_shardings,
)

__all__ = [
    "FailureInjector",
    "HeartbeatMonitor",
    "ShardingRules",
    "SimulatedFailure",
    "active_mesh",
    "active_rules",
    "constrain",
    "is_spec_leaf",
    "map_specs",
    "mesh_context",
    "rules_for_mesh",
    "run_with_recovery",
    "spec_tree_to_shardings",
]
