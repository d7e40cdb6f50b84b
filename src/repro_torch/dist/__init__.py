"""The distributed substrate: meters, cost closed forms, tree schedules,
the single-process ``Collectives`` backends and seeded fault injection
(port of ``repro.dist``)."""

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
from repro_torch.dist.tree import (
    broadcast_schedule,
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
    "SimBackend",
    "broadcast_schedule",
    "simulate_tree_sum",
    "tree_order_sum",
    "tree_rounds",
    "tree_schedule",
    "WorkerCrashError",
]
