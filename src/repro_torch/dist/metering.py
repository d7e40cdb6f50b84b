"""``CommReport`` — the communication report type benchmarks consume.

Port of ``repro.dist.metering`` (pure Python).

A ``CommReport`` is the frozen, serializable summary of one method's run
through a :class:`repro_torch.dist.collectives.Collectives` backend: scalars and bytes on
the wire, latency rounds, the per-kind breakdown, and modeled wall-clock.
Because every method meters through the same backend machinery, reports
are apples-to-apples across FD-SVRG and the instance-distributed
baselines — the property the paper's Figure 7 / Tables 2–3 comparisons
rest on.

``benchmarks/run.py`` serializes these into ``BENCH_*.json`` (schema
documented in ``docs/benchmarks.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.dist.meter import ClusterModel, CommMeter


@dataclasses.dataclass(frozen=True)
class CommReport:
    """One method's bytes-on-the-wire and modeled time, from one meter."""

    method: str
    q: int  # worker count
    scalars: int  # total scalars communicated
    rounds: int  # total latency-bearing message rounds
    bytes_on_wire: int  # scalars * bytes_per_scalar
    by_kind: dict[str, int]  # scalars per message kind
    modeled_time_s: float  # accumulated ClusterModel wall-clock

    @classmethod
    def from_meter(
        cls,
        *,
        method: str,
        q: int,
        meter: CommMeter,
        cluster: ClusterModel | None = None,
        modeled_time_s: float = 0.0,
    ) -> "CommReport":
        cluster = cluster or ClusterModel()
        return cls(
            method=method,
            q=q,
            scalars=meter.total_scalars,
            rounds=meter.total_rounds,
            bytes_on_wire=meter.total_scalars * cluster.bytes_per_scalar,
            by_kind=dict(meter.by_kind),
            modeled_time_s=modeled_time_s,
        )

    @classmethod
    def from_result(
        cls,
        method: str,
        q: int,
        result: Any,
        cluster: ClusterModel | None = None,
    ) -> "CommReport":
        """Summarize a ``RunResult``-shaped object (``.meter`` plus a
        ``.history`` whose last record carries ``modeled_time_s``)."""
        modeled = result.history[-1].modeled_time_s if result.history else 0.0
        return cls.from_meter(
            method=method, q=q, meter=result.meter,
            cluster=cluster, modeled_time_s=modeled,
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "method": self.method,
            "workers": self.q,
            "comm_scalars": self.scalars,
            "comm_rounds": self.rounds,
            "bytes_on_wire": self.bytes_on_wire,
            "by_kind": dict(sorted(self.by_kind.items())),
            "modeled_time_s": self.modeled_time_s,
        }


def reports_to_json(reports: Mapping[str, CommReport]) -> dict[str, Any]:
    """Keyed collection of reports in the BENCH_*.json layout."""
    return {name: r.to_dict() for name, r in sorted(reports.items())}
