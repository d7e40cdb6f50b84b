"""The distributed substrate: meters, cost closed forms, tree schedules,
the single-process ``Collectives`` backends, the deployable
``ShardMapBackend`` over ``torch.distributed`` (one process per rank,
started by :func:`repro_torch.dist.launch.spawn_ranks`) and seeded fault
injection (port of ``repro.dist``)."""

from repro_torch.dist.collectives import Collectives, LocalBackend, SimBackend
from repro_torch.dist.costs import COSTS, CostModel, PhaseCost
from repro_torch.dist.faults import (
    FaultError,
    FaultPlan,
    FaultyBackend,
    RetriesExhaustedError,
    RetryPolicy,
    WorkerCrashError,
)
from repro_torch.dist.meter import ClusterModel, CommEvent, CommMeter, tree_rounds
from repro_torch.dist.metering import CommReport
from repro_torch.dist.shardmap import ShardMapBackend
from repro_torch.dist.tree import (
    broadcast_schedule,
    collective_permute_tree,
    psum_tree,
    simulate_tree_sum,
    tree_order_sum,
    tree_schedule,
)

__all__ = [
    "COSTS",
    "ClusterModel",
    "Collectives",
    "CommEvent",
    "CommMeter",
    "CommReport",
    "CostModel",
    "FaultError",
    "FaultPlan",
    "FaultyBackend",
    "LocalBackend",
    "PhaseCost",
    "RetriesExhaustedError",
    "RetryPolicy",
    "ShardMapBackend",
    "SimBackend",
    "broadcast_schedule",
    "collective_permute_tree",
    "psum_tree",
    "simulate_tree_sum",
    "tree_order_sum",
    "tree_rounds",
    "tree_schedule",
    "WorkerCrashError",
]
