"""The distributed substrate: meters, cost closed forms, tree schedules and
the single-process ``Collectives`` backends (port of ``repro.dist``)."""

from repro_torch.dist.collectives import Collectives, LocalBackend, SimBackend
from repro_torch.dist.costs import COSTS, CostModel, PhaseCost
from repro_torch.dist.faults import FaultError
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
    "LocalBackend",
    "PhaseCost",
    "SimBackend",
    "broadcast_schedule",
    "simulate_tree_sum",
    "tree_order_sum",
    "tree_rounds",
    "tree_schedule",
]
