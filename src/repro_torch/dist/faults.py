"""Deterministic fault injection at the ``Collectives`` boundary.

Port of ``repro.dist.faults``.  Cluster failure modes are first-class
and seeded, so a chaos run is as reproducible as a clean one:

* :class:`FaultPlan` — a frozen, seeded description of which faults fire
  (drop / straggler / corruption probabilities, worker crashes pinned to
  outer iterations).  The same plan draws the same fault sequence as the
  reference's (NumPy ``default_rng``, one draw per decision in
  collective-call order).
* :class:`RetryPolicy` — bounded retransmissions with exponential
  backoff, deterministic jitter and a per-collective timeout.
* :class:`FaultyBackend` — a wrapper conforming to the
  :class:`~repro_torch.dist.collectives.Collectives` protocol over any
  backend of :mod:`repro_torch.dist.collectives`.  No driver code knows
  faults exist.

Honest accounting: every failed attempt's traffic is recorded in the
shared ``CommMeter`` under the ``"retry"`` kind (the scalars and rounds
of the collective it retransmits) and its timeout plus backoff is charged
to modeled time; the delivered attempt is the inner backend's own,
untouched.  So::

    meter.total_scalars == fault-free schedule + meter.by_kind["retry"]

exactly.  A drop-only or straggler-only run is bit for bit the fault-free
run (values are unchanged; only bytes and modeled time grow).  A
corruption poisons lane 0 of an executing ``all_reduce``'s result with
NaN, for the harness's divergence guard to catch; a crash, armed by
``begin_outer`` and raised from the next collective call, is recovered
by epoch-abort to the snapshot.  ``q <= 1`` backends carry no wire
traffic, so no faults fire on them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.dist.costs import PhaseCost
from repro_torch.dist.meter import ClusterModel, CommMeter, tree_rounds
from repro_torch.dist.metering import CommReport


class FaultError(RuntimeError):
    """Base class for injected/derived run faults (see also
    :class:`repro_torch.core.driver.DivergenceError`, which subclasses this so
    the harness's recovery path catches both with one handler)."""


class WorkerCrashError(FaultError):
    """A worker died; its in-epoch state is gone.  Recoverable only by
    epoch-abort to the replicated snapshot."""


class RetriesExhaustedError(FaultError):
    """A collective failed ``max_retries + 1`` consecutive attempts."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded description of the faults a run experiences.

    Deterministic by construction: the plan owns a PRNG seed, and the
    wrapper consumes one draw per fault decision in collective-call
    order.  The same plan over the same call sequence yields the same
    faults — replaying the metering schedule against a second wrapper
    reproduces the ``"retry"`` byte count exactly.
    """

    seed: int = 0
    drop_prob: float = 0.0  # P(an attempt's messages are lost)
    straggler_prob: float = 0.0  # P(one worker stalls this attempt)
    straggler_delay_s: float = 5e-3  # max stall; actual ~ U(0, max)
    corrupt_prob: float = 0.0  # P(reduced payload arrives NaN), all_reduce only
    crash_at_outer: tuple[int, ...] = ()  # worker crash at these outer iters

    def __post_init__(self) -> None:
        for name in ("drop_prob", "straggler_prob", "corrupt_prob"):
            p = getattr(self, name)
            if not 0.0 <= p < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {p!r}")
        if self.straggler_delay_s < 0:
            raise ValueError("straggler_delay_s >= 0 required")
        # normalize a stray int / list into the canonical tuple
        crash = self.crash_at_outer
        if isinstance(crash, int):
            crash = (crash,)
        object.__setattr__(self, "crash_at_outer", tuple(int(t) for t in crash))

    @property
    def is_noop(self) -> bool:
        return (
            self.drop_prob == 0.0
            and self.straggler_prob == 0.0
            and self.corrupt_prob == 0.0
            and not self.crash_at_outer
        )

    def rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retransmission with exponential backoff + jitter.

    A failed attempt costs ``timeout_s`` (the wait that detected the
    loss) plus ``backoff_base_s * backoff_factor**attempt * (1 + j)``
    with ``j ~ U(0, jitter)`` drawn from the plan's PRNG — all charged to
    modeled time, never to the meter's byte count (bytes that were never
    re-sent aren't bytes; the retransmission itself is the ``"retry"``
    record).
    """

    max_retries: int = 3  # retransmissions allowed after the first attempt
    backoff_base_s: float = 1e-3
    backoff_factor: float = 2.0
    jitter: float = 0.1  # uniform multiplicative jitter on the backoff
    timeout_s: float = 0.1  # per-collective wait before declaring a drop

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries >= 0 required")
        if min(self.backoff_base_s, self.backoff_factor, self.jitter,
               self.timeout_s) < 0:
            raise ValueError("RetryPolicy time constants must be >= 0")

    def backoff_s(self, attempt: int, jitter_draw: float) -> float:
        return (
            self.backoff_base_s
            * self.backoff_factor ** attempt
            * (1.0 + self.jitter * jitter_draw)
        )


class FaultyBackend:
    """A ``Collectives`` backend that injects ``plan``'s faults into
    ``inner`` and meters the recovery honestly.

    Composes over any backend: the wrapper owns no meter, no cluster, and
    no modeled clock — everything delegates to ``inner``, so a wrapped
    run reports through the exact same accounting objects as a clean one
    and ``RunResult.meter is backend.meter`` keeps holding.
    """

    def __init__(
        self,
        inner,
        plan: FaultPlan,
        retry: RetryPolicy | None = None,
    ) -> None:
        self.inner = inner
        self.plan = plan
        self.retry = retry or RetryPolicy()
        self._rng = plan.rng()
        self._armed_outer: int | None = None  # crash pending for this outer
        self._crashed: set[int] = set()  # outers whose crash already fired

    # -- delegated protocol surface --------------------------------------

    @property
    def q(self) -> int:
        return self.inner.q

    @property
    def meter(self) -> CommMeter:
        return self.inner.meter

    @property
    def cluster(self) -> ClusterModel:
        return self.inner.cluster

    def charge(self, *, flops: float = 0.0, scalars: float = 0.0,
               rounds: float = 0.0) -> None:
        self.inner.charge(flops=flops, scalars=scalars, rounds=rounds)

    def charge_seconds(self, seconds: float) -> None:
        self.inner.charge_seconds(seconds)

    def charge_cost(self, cost: PhaseCost, steps: int = 1) -> None:
        self.inner.charge_cost(cost, steps)

    @property
    def modeled_time_s(self) -> float:
        return self.inner.modeled_time_s

    @property
    def tree_rounds(self) -> int:
        return self.inner.tree_rounds

    def report(self, method: str = "") -> CommReport:
        return self.inner.report(method)

    # -- crash arming (driven by the outer-loop harness) ------------------

    def begin_outer(self, t: int) -> None:
        """Arm the plan's crash for outer ``t``; it fires at the next
        collective call.  A crash fires once per outer — the restarted
        worker (post epoch-abort) does not re-crash."""
        if int(t) in self.plan.crash_at_outer and int(t) not in self._crashed:
            self._armed_outer = int(t)

    def _maybe_crash(self) -> None:
        if self._armed_outer is not None:
            t, self._armed_outer = self._armed_outer, None
            self._crashed.add(t)
            raise WorkerCrashError(
                f"worker crashed at outer iteration {t} (FaultPlan seed "
                f"{self.plan.seed})"
            )

    # -- the fault loop ----------------------------------------------------

    def _deliver(self, scalars: int, rounds: int, execute: Callable):
        """Run one collective under the plan: failed attempts meter their
        retransmitted traffic under ``"retry"`` and charge timeout +
        backoff; the successful attempt is ``execute()`` — the inner
        backend's own (metered) primitive, untouched."""
        self._maybe_crash()
        if self.q <= 1 or scalars <= 0:
            return execute()  # nothing on the wire -> nothing can fail
        for attempt in range(self.retry.max_retries + 1):
            r_drop, r_straggle = self._rng.random(2)
            delay = 0.0
            if r_straggle < self.plan.straggler_prob:
                delay = self.plan.straggler_delay_s * self._rng.random()
            if r_drop < self.plan.drop_prob or delay > self.retry.timeout_s:
                # Lost (or timed out): the attempt's traffic was spent for
                # nothing and must be retransmitted — that is the honest
                # overhead of the fault, metered under its own kind.
                self.inner.meter.record("retry", scalars, rounds)
                self.inner.charge_seconds(
                    self.retry.timeout_s
                    + self.retry.backoff_s(attempt, self._rng.random())
                )
                continue
            if delay > 0.0:
                self.inner.charge_seconds(delay)  # slow, but it arrived
            return execute()
        raise RetriesExhaustedError(
            f"collective failed {self.retry.max_retries + 1} consecutive "
            f"attempts (drop_prob={self.plan.drop_prob}, seed="
            f"{self.plan.seed}); raise RetryPolicy.max_retries or recover "
            "via epoch abort"
        )

    # -- Collectives primitives, faulted ----------------------------------

    def all_reduce(self, parts: Sequence, payload: int | None = None):
        p = int(payload) if payload is not None else int(
            torch.as_tensor(parts[0]).numel()
        )
        scalars = 2 * self.q * p if self.q > 1 else 0
        out = self._deliver(
            scalars, tree_rounds(self.q),
            lambda: self.inner.all_reduce(parts, payload),
        )
        if self.q > 1 and self._rng.random() < self.plan.corrupt_prob:
            # The broadcast leg delivered a mangled payload: poison one
            # lane.  Detection is the harness's divergence guard.
            out = torch.as_tensor(out).clone()
            out.view(-1)[0] = float("nan")
        return out

    def meter_tree(self, payload: int, steps: int = 1) -> None:
        for _ in range(int(steps)):
            self._deliver(
                2 * self.q * payload if self.q > 1 else 0,
                tree_rounds(self.q),
                lambda: self.inner.meter_tree(payload, steps=1),
            )

    def p2p(self, payload: int, kind: str, rounds: int = 1) -> None:
        self._deliver(
            int(payload), int(rounds),
            lambda: self.inner.p2p(payload, kind, rounds),
        )
