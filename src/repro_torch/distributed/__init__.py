"""Fault tolerance and sharding specs (``repro/distributed``).

The heartbeat monitor and the recovery loop are ported, and so are the
sharding rules and spec-tree helpers (``sharding.py``).  Placing tensors
by those specs over a ``torch.distributed`` mesh (the reference's
``spec_tree_to_shardings``) waits for the sharded step (``ROADMAP.md``,
queue 1, item 11g-2).
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
]
