"""The ``Collectives`` protocol and its single-process backends.

Port of ``repro.dist.collectives``.  A backend bundles the worker count
``q``, a :class:`~repro_torch.dist.meter.CommMeter` and a
:class:`~repro_torch.dist.meter.ClusterModel`, and exposes executing
collectives (``all_reduce``) and metering-only primitives (``meter_tree``,
``p2p``, ``charge*``) with the same closed forms as the reference.

* :class:`LocalBackend` — sums partials directly, in canonical tree order.
* :class:`SimBackend` — runs the explicit Figure-5 message schedule via
  :func:`~repro_torch.dist.tree.simulate_tree_sum`.
* :class:`repro_torch.dist.shardmap.ShardMapBackend` — the deployable
  path: one process per worker over a ``torch.distributed`` group.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import torch

from repro_torch.dist.costs import PhaseCost
from repro_torch.dist.meter import ClusterModel, CommMeter, tree_rounds
from repro_torch.dist.metering import CommReport
from repro_torch.dist.tree import simulate_tree_sum, tree_order_sum


@runtime_checkable
class Collectives(Protocol):
    """What an optimization method needs from the distributed substrate."""

    q: int
    meter: CommMeter
    cluster: ClusterModel

    def all_reduce(self, parts: Sequence, payload: int | None = None):
        """Combine per-worker partials into the replicated global sum,
        metering one tree reduce+broadcast of ``payload`` scalars."""
        ...

    def meter_tree(self, payload: int, steps: int = 1) -> None:
        """Meter ``steps`` tree reduce+broadcasts of ``payload`` scalars
        without executing them."""
        ...

    def p2p(self, payload: int, kind: str, rounds: int = 1) -> None:
        """Meter a point-to-point transfer of ``payload`` scalars."""
        ...

    def charge(
        self, *, flops: float = 0.0, scalars: float = 0.0, rounds: float = 0.0
    ) -> None:
        """Accumulate modeled wall-clock for a critical-path segment."""
        ...

    def charge_seconds(self, seconds: float) -> None:
        """Accumulate pre-computed modeled wall-clock."""
        ...

    def charge_cost(self, cost: PhaseCost, steps: int = 1) -> None:
        """Accumulate modeled wall-clock for ``steps`` repetitions of one
        :class:`~repro_torch.dist.costs.PhaseCost`."""
        ...

    @property
    def modeled_time_s(self) -> float: ...

    @property
    def tree_rounds(self) -> int: ...

    def report(self, method: str = "") -> CommReport: ...


class MeteredBackend:
    """Shared metering/cost machinery; subclasses supply ``all_reduce``."""

    def __init__(self, q: int, cluster: ClusterModel | None = None) -> None:
        if q < 1:
            raise ValueError(f"need q >= 1 workers, got {q}")
        self.q = int(q)
        self.cluster = cluster or ClusterModel()
        self.meter = CommMeter()
        self._modeled_time = 0.0

    def meter_tree(self, payload: int, steps: int = 1) -> None:
        self.meter.tree_reduce_broadcast(self.q, payload, steps)

    def p2p(self, payload: int, kind: str, rounds: int = 1) -> None:
        self.meter.record(kind, payload, rounds)

    def charge(
        self, *, flops: float = 0.0, scalars: float = 0.0, rounds: float = 0.0
    ) -> None:
        self._modeled_time += self.cluster.time(
            critical_flops=flops, critical_scalars=scalars, rounds=rounds
        )

    def charge_seconds(self, seconds: float) -> None:
        self._modeled_time += float(seconds)

    def charge_cost(self, cost: PhaseCost, steps: int = 1) -> None:
        self._modeled_time += steps * self.cluster.time(
            critical_flops=cost.flops,
            critical_scalars=cost.scalars,
            rounds=cost.rounds,
        )

    @property
    def modeled_time_s(self) -> float:
        return self._modeled_time

    @property
    def tree_rounds(self) -> int:
        """Latency rounds of one tree reduce+broadcast at this q."""
        return tree_rounds(self.q)

    def _check_parts(self, parts: Sequence) -> None:
        if len(parts) != self.q:
            raise ValueError(
                f"all_reduce needs one partial per worker: got {len(parts)} "
                f"parts for q={self.q}"
            )

    def _host_all_reduce(self, parts: Sequence, payload: int | None):
        """Shared host-side reduction: validate one partial per worker,
        meter the closed form, sum in canonical tree order."""
        self._check_parts(parts)
        parts = [torch.as_tensor(p) for p in parts]
        if payload is None:
            payload = int(parts[0].numel())
        self.meter_tree(payload)
        return tree_order_sum(parts)

    def report(self, method: str = "") -> CommReport:
        return CommReport.from_meter(
            method=method,
            q=self.q,
            meter=self.meter,
            cluster=self.cluster,
            modeled_time_s=self._modeled_time,
        )


class LocalBackend(MeteredBackend):
    """Single-process reference backend: sums the partials directly, in
    canonical tree order, with the standard accounting."""

    def all_reduce(self, parts: Sequence, payload: int | None = None):
        return self._host_all_reduce(parts, payload)


class SimBackend(MeteredBackend):
    """The executable spec: runs the explicit Figure-5 message schedule."""

    def all_reduce(self, parts: Sequence, payload: int | None = None):
        self._check_parts(parts)
        return simulate_tree_sum(parts, meter=self.meter, payload=payload)
