"""The §4.5 cost closed forms — ONE place, every consumer.

Port of ``repro.dist.costs`` (pure Python, copied so the port stands
alone).

Three things used to hold private copies of the per-outer cost
arithmetic: ``run_fdsvrg``, ``run_fdsvrg_sharded``, and
``benchmarks.common.analytic_outer`` — and they drifted (different
per-step compute terms, different PS pull conventions).  This module is
now the only implementation:

* the **measured-sim drivers** charge phase by phase
  (:meth:`CostModel.fd_fullgrad`, :meth:`CostModel.fd_inner_step`, …)
  through ``Collectives.charge_cost``;
* the **analytic benchmark schedules** aggregate the same phases into a
  per-outer total (:meth:`CostModel.outer_cost`) at the paper's full
  Table-1 sizes;
* the **drift-guard test** (``tests/test_driver.py``) runs every method
  and asserts the measured meter and the analytic schedule agree on
  scalars-per-outer (and modeled seconds) exactly.

Conventions, applied to every method alike:

* **Scalars** are the § 4.5 wire unit.  A Figure-5 tree reduce+broadcast
  of ``p`` scalars among q workers is ``2·q·p`` scalars in
  ``2⌈log₂q⌉`` rounds; ``q ≤ 1`` communicates nothing.  PS workers pull
  the dense ``w`` (d scalars) and push sparse <key,value> gradients
  (``2·u·nnz`` scalars) — the paper's concession to the baselines.
* **Compute** follows the lazy sparse-update trick for every method:
  one sampled (VR-)gradient costs O(nnz) — O(nnz/q) per worker under
  the feature partition, where each worker touches only its block's
  entries — and dense regularizer/z terms are folded lazily instead of
  being charged as O(d) per step.
* **Modeled seconds** for a linear phase are
  ``flops/flops_per_s + scalars·bytes_per_scalar/bandwidth +
  rounds·latency`` (:meth:`~repro_torch.dist.meter.ClusterModel.time`); the
  asynchronous PS inner loop is the one nonlinear phase —
  ``max(compute/q, server bandwidth)`` per step — and has its own
  closed form here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.dist.meter import ClusterModel, tree_rounds


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """One critical-path segment: per-worker flops, wire scalars, and
    latency-bearing rounds.  Feed to ``Collectives.charge_cost`` (drivers)
    or :meth:`CostModel.seconds` (analytic schedules)."""

    flops: float = 0.0
    scalars: int = 0
    rounds: int = 0


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Paper §4.5 per-outer closed forms for all six optimizers."""

    # -- FD-SVRG (Algorithm 1; serial SVRG is the q = 1 specialization) --

    def fd_fullgrad(self, *, n: int, nnz: int, q: int, k: int = 1) -> PhaseCost:
        """Full-gradient phase (Alg 1 lines 3-5): per-worker margins +
        scatter over the local block, one N-payload tree.  ``k`` is the
        multi-output width (w ∈ R^{d×k}): per-nonzero work and the tree
        payload both scale by k, the round count does not (the k margin
        vectors ride one tree)."""
        return PhaseCost(
            flops=4.0 * n * nnz * k / q,
            scalars=2 * q * n * k if q > 1 else 0,
            rounds=tree_rounds(q),
        )

    def fd_inner_step(self, *, nnz: int, q: int, u: int, k: int = 1) -> PhaseCost:
        """One inner step (Alg 1 lines 9-11): per-worker sparse work on
        the sampled rows' local entries, one u-payload tree (u·k scalars
        for multi-output — see :meth:`fd_fullgrad`)."""
        return PhaseCost(
            flops=2.0 * u * nnz * k / q,
            scalars=2 * q * u * k if q > 1 else 0,
            rounds=tree_rounds(q),
        )

    # -- FD-SAGA (feature-distributed SAGA, replicated scalar table) -----

    def fd_saga_init(self, *, n: int, nnz: int, q: int) -> PhaseCost:
        """Table initialization (once per run, not per outer): one
        full-gradient-shaped pass sets the n-float margin-derivative
        table α and its running mean z — the table is *scalars per
        instance*, so replicating it costs one N-payload tree, same wire
        shape as the FD-SVRG full-gradient phase (never an O(d)
        gradient table per worker)."""
        return PhaseCost(
            flops=4.0 * n * nnz / q,
            scalars=2 * q * n if q > 1 else 0,
            rounds=tree_rounds(q),
        )

    def fd_saga_step(self, *, nnz: int, q: int, u: int) -> PhaseCost:
        """One FD-SAGA inner step: margins gather + direction scatter +
        table-mean scatter on the sampled rows' local entries (3 sparse
        passes vs FD-SVRG's 2 — SAGA folds its snapshot maintenance into
        every step), one u-payload tree exactly like the SVRG step."""
        return PhaseCost(
            flops=6.0 * u * nnz / q,
            scalars=2 * q * u if q > 1 else 0,
            rounds=tree_rounds(q),
        )

    # -- FD-BCD (distributed block coordinate descent, Mahajan et al.) ---

    def fd_bcd_step(self, *, n: int, nnz: int, q: int) -> PhaseCost:
        """One BCD block update: the active worker scatters the full data
        gradient restricted to its block (all N rows' local entries) and
        re-computes its block's margin delta, then the delta is
        tree-replicated so every worker's maintained margins stay
        consistent — an N-payload tree per step, the price BCD pays for
        updating whole blocks instead of sampled rows."""
        return PhaseCost(
            flops=4.0 * n * nnz / q,
            scalars=2 * q * n if q > 1 else 0,
            rounds=tree_rounds(q),
        )

    # -- DSVRG (Lee et al.: ring of instance shards) ---------------------

    def dsvrg_fullgrad(self, *, n: int, d: int, nnz: int, q: int) -> PhaseCost:
        """Parallel full gradient: center <-> q machines, dense d each way."""
        return PhaseCost(flops=4.0 * (n / q) * nnz, scalars=2 * q * d, rounds=2)

    def dsvrg_epoch(self, *, m: int, nnz: int, d: int, u: int) -> PhaseCost:
        """M serial inner steps on one machine + the dense parameter
        handoff (center -> J: full gradient; J -> center: parameter)."""
        return PhaseCost(flops=2.0 * m * u * nnz, scalars=2 * d, rounds=2)

    # -- Parameter-server family (Appendix B) ----------------------------

    def ps_fullgrad(self, *, n: int, d: int, nnz: int, q: int) -> PhaseCost:
        """Dense full-gradient round: q workers pull w and push grads."""
        return PhaseCost(flops=4.0 * (n / q) * nnz, scalars=2 * q * d, rounds=2)

    def syn_inner_step(self, *, d: int, nnz: int, q: int, u: int) -> PhaseCost:
        """One synchronous step: q workers each pull dense w (d) and push
        a sparse <key,value> VR gradient (2·u·nnz)."""
        return PhaseCost(
            flops=2.0 * u * nnz, scalars=q * (d + 2 * u * nnz), rounds=2
        )

    def async_step_scalars(self, *, d: int, nnz: int, u: int = 1) -> int:
        """One async step's traffic: one worker pulls dense w, pushes a
        sparse <key,value> (VR-)gradient."""
        return d + 2 * u * nnz

    def async_step_seconds(
        self, cluster: ClusterModel, *, d: int, nnz: int, q: int, u: int = 1
    ) -> float:
        """Async throughput: q workers overlap compute, the server
        serializes message handling — per-step time is the max of the
        overlapped compute and the server's wire time."""
        scalars = self.async_step_scalars(d=d, nnz=nnz, u=u)
        return max(
            2.0 * u * nnz / (cluster.flops_per_s * q),
            scalars * cluster.bytes_per_scalar / cluster.bandwidth_Bps,
        )

    # -- aggregation -----------------------------------------------------

    def seconds(self, cluster: ClusterModel, cost: PhaseCost) -> float:
        return cluster.time(
            critical_flops=cost.flops,
            critical_scalars=cost.scalars,
            rounds=cost.rounds,
        )

    def outer_cost(
        self,
        method: str,
        *,
        n: int,
        d: int,
        nnz: int,
        q: int,
        u: int = 1,
        inner_steps: int | None = None,
        cluster: ClusterModel | None = None,
    ) -> tuple[float, int]:
        """(modeled seconds, scalars) for ONE outer iteration of ``method``.

        ``inner_steps=None`` applies the paper's M conventions (FD: N/u;
        DSVRG/SynSVRG: N/q; AsySVRG/PS-Lite: N); pass the actual M to
        match a measured run exactly — the drift-guard test asserts that
        a driver's meter and this closed form agree per outer.
        """
        cl = cluster or ClusterModel()
        if method == "serial":
            method, q, u = "fdsvrg", 1, u
        if method == "fdsvrg":
            m = inner_steps if inner_steps is not None else max(1, n // u)
            fg = self.fd_fullgrad(n=n, nnz=nnz, q=q)
            st = self.fd_inner_step(nnz=nnz, q=q, u=u)
            return (
                self.seconds(cl, fg) + m * self.seconds(cl, st),
                fg.scalars + m * st.scalars,
            )
        if method == "fd_saga":
            m = inner_steps if inner_steps is not None else max(1, n // u)
            st = self.fd_saga_step(nnz=nnz, q=q, u=u)
            # Steady-state per-outer cost; the one-time table init is
            # :meth:`init_cost` (the drift guard pins meter == init +
            # outers * this).
            return m * self.seconds(cl, st), m * st.scalars
        if method == "fd_bcd":
            m = inner_steps if inner_steps is not None else max(1, q)
            st = self.fd_bcd_step(n=n, nnz=nnz, q=q)
            return m * self.seconds(cl, st), m * st.scalars
        if method == "dsvrg":
            m = inner_steps if inner_steps is not None else max(1, n // q)
            fg = self.dsvrg_fullgrad(n=n, d=d, nnz=nnz, q=q)
            ep = self.dsvrg_epoch(m=m, nnz=nnz, d=d, u=u)
            return (
                self.seconds(cl, fg) + self.seconds(cl, ep),
                fg.scalars + ep.scalars,
            )
        if method == "synsvrg":
            m = inner_steps if inner_steps is not None else max(1, n // q)
            fg = self.ps_fullgrad(n=n, d=d, nnz=nnz, q=q)
            st = self.syn_inner_step(d=d, nnz=nnz, q=q, u=u)
            return (
                self.seconds(cl, fg) + m * self.seconds(cl, st),
                fg.scalars + m * st.scalars,
            )
        if method in ("asysvrg", "pslite_sgd"):
            m = inner_steps if inner_steps is not None else n
            time_s = m * self.async_step_seconds(cl, d=d, nnz=nnz, q=q, u=u)
            scalars = m * self.async_step_scalars(d=d, nnz=nnz, u=u)
            if method == "asysvrg":
                fg = self.ps_fullgrad(n=n, d=d, nnz=nnz, q=q)
                time_s += self.seconds(cl, fg)
                scalars += fg.scalars
            return time_s, scalars
        raise ValueError(
            f"unknown method {method!r} in CostModel.outer_cost; methods "
            "with closed forms: serial, fdsvrg, fd_saga, fd_bcd, dsvrg, "
            "synsvrg, asysvrg, pslite_sgd"
        )

    def init_cost(
        self,
        method: str,
        *,
        n: int,
        nnz: int,
        q: int,
        cluster: ClusterModel | None = None,
    ) -> tuple[float, int]:
        """(modeled seconds, scalars) charged ONCE per run, before the
        per-outer schedule — zero for every method except ``fd_saga``,
        whose gradient-table initialization is a one-time full-gradient-
        shaped phase (:meth:`fd_saga_init`)."""
        if method == "fd_saga":
            cost = self.fd_saga_init(n=n, nnz=nnz, q=q)
            return self.seconds(cluster or ClusterModel(), cost), cost.scalars
        return 0.0, 0


#: The shared instance every driver and benchmark consumes.
COSTS = CostModel()
