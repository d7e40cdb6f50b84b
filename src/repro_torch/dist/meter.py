"""Communication accounting and wall-clock cost models.

Port of ``repro.dist.meter`` (pure Python, copied so the port stands
alone; the reference's TPU roofline model is not carried over).

The paper's Figure 7 x-axis is "how many scalars have been communicated";
its complexity analysis (§4.5) counts, per N gradients:

    FD-SVRG : 2qN scalars        (tree reduce+broadcast of one scalar)
    DSVRG   : 2qd scalars        (full-gradient round + parameter handoff)
    PS SVRG : O((N + d) d / ...) — dense vectors every inner step.

``CommMeter`` records every message a simulated algorithm sends so tests
can check the closed forms *exactly*, and benchmarks can plot Figure 7.
Every backend of the :class:`repro_torch.dist.collectives.Collectives` protocol owns one
meter, so all methods report through the same accounting.

``ClusterModel`` converts (flops, messages) into simulated wall-clock for
Figure 6 / Tables 2–3-style results: we are on one CPU, so time is modeled,
not measured — parameters mirror the paper's cluster (10GbE, Xeon E5-2620).
The model is deliberately simple and is validated qualitatively (ordering,
scaling trends), never used for correctness claims.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict


def tree_rounds(q: int) -> int:
    """Latency-bearing rounds of one Figure-5 tree reduce+broadcast."""
    if q <= 1:
        return 0
    return 2 * max(1, math.ceil(math.log2(q)))


@dataclasses.dataclass
class CommEvent:
    kind: str  # e.g. "tree_reduce", "push", "pull", "ring"
    scalars: int
    rounds: int  # latency-bearing sequential rounds this event took


class CommMeter:
    """Counts scalars communicated, message rounds, and per-kind breakdown."""

    def __init__(self) -> None:
        self.total_scalars = 0
        self.total_rounds = 0
        self.by_kind: dict[str, int] = defaultdict(int)
        self.events: list[CommEvent] = []

    def record(self, kind: str, scalars: int, rounds: int = 1) -> None:
        scalars = int(scalars)
        rounds = int(rounds)
        self.total_scalars += scalars
        self.total_rounds += rounds
        self.by_kind[kind] += scalars
        self.events.append(CommEvent(kind, scalars, rounds))

    # -- canonical communication patterns -------------------------------

    def tree_reduce_broadcast(self, q: int, payload: int = 1, steps: int = 1) -> None:
        """Paper §4.5: tree reduce + reverse broadcast of `payload` scalars
        among q workers costs 2*q*payload scalars in ~2*ceil(log2 q) rounds
        (Figure 5: solid arrows = q per direction, counting the coordinator
        hop).  ``steps`` meters that many identical trees in one event.
        """
        if q <= 1 or steps <= 0:
            return
        self.record(
            "tree_reduce", 2 * q * payload * steps, tree_rounds(q) * steps
        )

    def point_to_point(self, payload: int, kind: str = "p2p") -> None:
        self.record(kind, payload, 1)

    def snapshot(self) -> dict[str, int]:
        return {
            "total_scalars": self.total_scalars,
            "total_rounds": self.total_rounds,
            **{f"kind:{k}": v for k, v in sorted(self.by_kind.items())},
        }

    # -- checkpoint support ----------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable full state (counters AND the event log), so a
        resumed run's meter is indistinguishable from an uninterrupted one."""
        return {
            "total_scalars": self.total_scalars,
            "total_rounds": self.total_rounds,
            "by_kind": dict(self.by_kind),
            "events": [[e.kind, e.scalars, e.rounds] for e in self.events],
        }

    def load_state(self, state: dict) -> None:
        self.total_scalars = int(state["total_scalars"])
        self.total_rounds = int(state["total_rounds"])
        self.by_kind = defaultdict(int)
        for k, v in state["by_kind"].items():
            self.by_kind[k] = int(v)
        self.events = [
            CommEvent(str(k), int(s), int(r)) for k, s, r in state["events"]
        ]


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """Wall-clock simulator mirroring the paper's cluster.

    time = flops_on_critical_path / flops_per_s
         + scalars_on_critical_path * bytes_per_scalar / bandwidth
         + rounds * latency
    """

    flops_per_s: float = 2.0e9  # per-core effective sparse-ops throughput
    bandwidth_Bps: float = 1.25e9  # 10 GbE
    latency_s: float = 50e-6  # small-message RTT on Ethernet
    bytes_per_scalar: int = 8

    def time(
        self, *, critical_flops: float, critical_scalars: float, rounds: float
    ) -> float:
        return (
            critical_flops / self.flops_per_s
            + critical_scalars * self.bytes_per_scalar / self.bandwidth_Bps
            + rounds * self.latency_s
        )
