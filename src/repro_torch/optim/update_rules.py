"""The update-rule layer: one outer-loop harness, pluggable inner steps.

Port of ``repro.optim.update_rules``: the context, the rule protocol,
:func:`run_with_rule`, and the three rules of :data:`RULES`:

* :class:`SVRGRule` — Prox-SVRG, dense or lazy; with a ``[N, k]`` label
  matrix, multi-output ``w ∈ R^{d×k}`` with one sample stream and step
  mask for all k outputs (the reference's ``vmap`` of the scalar epoch
  over columns): on the kernel route k scalar kernel-path snapshots and
  epochs, one a column; on the plain path batched torch ops over the
  trailing output axis;
* :class:`SAGARule` — feature-distributed SAGA: a replicated n-float
  gradient table and its running mean;
* :class:`BCDRule` — distributed block coordinate descent, one whole
  block a step.

Each rule's ``use_kernels`` (default ``True``) routes every function the
port has a kernel for through :mod:`repro_torch.kernels.ops`, never
``index_add_``, so its card runs are bitwise reproducible.

Import direction, as in the reference: this module imports the building
blocks from :mod:`repro_torch.core.fdsvrg`; the drivers there import this
module inside their function bodies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import (
    CheckpointPolicy,
    RecoveryPolicy,
    RunResult,
    draw_samples,
    make_same_iterate_eval,
    optimality_norm,
    option_mask,
    resolve_init_w,
    run_outer_loop,
)
from repro_torch.core.fdsvrg import (
    SVRGConfig,
    _bounds,
    _check_kernel_dtype,
    _check_lazy,
    _default_fd_abort,
    _full_grad_blocks,
    _gather_rows,
    _inner_epoch,
    _lazy_corrections,
    _lazy_inner_epoch,
    _to_device,
)
from repro_torch.data.block_csr import BlockCSR, local_margins, local_scatter
from repro_torch.dist import COSTS, Collectives, tree_order_sum
from repro_torch.kernels import ops
from repro_torch.kernels.block_scatter import scatter_index
from repro_torch.kernels.logistic_grad import snapshot_coef_plain
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class RuleContext:
    """One run's immutable inputs.  ``backend=None`` is the serial
    (unmetered) path; ``num_outputs`` is the output width k (1: labels
    are 1-D)."""

    block_data: BlockCSR
    loss: losses_lib.MarginLoss
    reg: losses_lib.Regularizer
    cfg: SVRGConfig
    backend: Collectives | None = None
    num_outputs: int = 1

    @property
    def labels(self) -> torch.Tensor:
        return self.block_data.labels

    @property
    def n(self) -> int:
        return self.block_data.num_instances

    @property
    def q(self) -> int:
        return self.block_data.num_blocks

    @property
    def u(self) -> int:
        return self.cfg.batch_size

    @property
    def nnz(self) -> int:
        return self.block_data.global_nnz_max()

    @property
    def dtype(self) -> torch.dtype:
        return self.block_data.values[0].dtype

    @property
    def device(self) -> torch.device:
        return self.block_data.device


def make_context(
    block_data: BlockCSR,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    *,
    backend: Collectives | None = None,
) -> RuleContext:
    """Build a :class:`RuleContext`, deriving the output width from the
    labels: a ``[N, k]`` label matrix means ``w ∈ R^{d×k}``; ``[N, 1]`` is
    squeezed onto the scalar path, so k = 1 is the 1-D run bit for bit."""
    labels = block_data.labels
    num_outputs = 1
    if labels.dim() == 2:
        num_outputs = int(labels.shape[1])
        if num_outputs == 1:
            block_data = dataclasses.replace(block_data, labels=labels[:, 0])
    if backend is not None and backend.q != block_data.num_blocks:
        raise ValueError(
            f"backend has q={backend.q} workers but block_data has "
            f"{block_data.num_blocks} blocks"
        )
    return RuleContext(
        block_data=block_data, loss=loss, reg=reg, cfg=cfg, backend=backend,
        num_outputs=num_outputs,
    )


class UpdateRule:
    """Base class: a rule owns its state carry, direction and metering.

    ``build_snapshot`` / ``build_epoch`` / ``build_evaluate`` are called
    once per run and return the harness hooks; state that carries across
    epochs but is not the harness's snapshot (SAGA's table, BCD's cursor)
    lives in the epoch closure.
    """

    name: str = "update_rule"
    supports_recovery: bool = False
    supports_checkpoint: bool = False
    supports_multi_output: bool = False
    supports_option_ii: bool = False

    def validate(self, ctx: RuleContext) -> None:
        if ctx.num_outputs > 1 and not self.supports_multi_output:
            raise ValueError(
                f"rule {self.name!r} does not support multi-output labels "
                f"(got a [N, {ctx.num_outputs}] label matrix)"
            )
        if ctx.cfg.option == "II" and not self.supports_option_ii:
            raise ValueError(
                f"rule {self.name!r} runs Option I only; option='II' "
                "would not be honored"
            )

    def build_snapshot(self, ctx: RuleContext) -> Callable:
        raise NotImplementedError

    def build_epoch(self, ctx: RuleContext) -> Callable:
        raise NotImplementedError

    def build_evaluate(self, ctx: RuleContext) -> Callable:
        return make_same_iterate_eval(ctx.labels, ctx.loss, ctx.reg, ctx.cfg.eta)

    def build_init_w(self, ctx: RuleContext, init_w) -> torch.Tensor:
        return resolve_init_w(init_w, ctx.block_data.dim, ctx.dtype, ctx.device,
                              ctx.num_outputs)

    def default_abort(self, ctx: RuleContext) -> Callable | None:
        return None


def run_with_rule(
    rule: UpdateRule,
    ctx: RuleContext,
    *,
    init_w=None,
    recovery: RecoveryPolicy | None = None,
    checkpoint: CheckpointPolicy | None = None,
) -> RunResult:
    """Wire one rule into the outer-loop harness and run it."""
    rule.validate(ctx)
    if recovery is not None and not rule.supports_recovery:
        raise ValueError(
            f"rule {rule.name!r} does not support epoch-abort recovery: its "
            "carried state (gradient table / block cursor) advances inside "
            "the epoch, so a snapshot retry would replay against mutated state"
        )
    if checkpoint is not None and not rule.supports_checkpoint:
        raise ValueError(
            f"rule {rule.name!r} does not support checkpoint/resume: the "
            "harness checkpoint only persists (w, z, s0), not the rule's "
            "carried state"
        )
    if recovery is not None and recovery.on_abort is None \
            and ctx.backend is not None:
        on_abort = rule.default_abort(ctx)
        if on_abort is not None:
            recovery = dataclasses.replace(recovery, on_abort=on_abort)
    return run_outer_loop(
        outer_iters=ctx.cfg.outer_iters,
        seed=ctx.cfg.seed,
        init_w=rule.build_init_w(ctx, init_w),
        snapshot=rule.build_snapshot(ctx),
        epoch=rule.build_epoch(ctx),
        evaluate=rule.build_evaluate(ctx),
        backend=ctx.backend,
        recovery=recovery,
        checkpoint=checkpoint,
    )


def _snapshot_hook(ctx: RuleContext, use_kernels: bool) -> Callable:
    bd, loss = ctx.block_data, ctx.loss

    def snapshot(w):
        return _full_grad_blocks(bd, w, loss, use_kernels)

    return snapshot


def _columns(ctx: RuleContext) -> list[BlockCSR]:
    """The layout once per output column, each with that column's labels
    (the rows and the scatter index shared): the multi-output kernel
    route runs one scalar kernel-path snapshot and epoch a column."""
    bd = ctx.block_data
    return [dataclasses.replace(bd, labels=bd.labels[:, j].contiguous())
            for j in range(ctx.num_outputs)]


# ---------------------------------------------------------------------------
# SVRG
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SVRGRule(UpdateRule):
    """Prox-SVRG: the snapshot pair (z, s0) is the whole state.

    ``use_kernels`` (default ``True``) runs the hot paths through
    :mod:`repro_torch.kernels.ops`.  ``lazy_updates`` ("exact" | "proba")
    swaps the dense inner epoch for the delayed-decay one
    (:func:`~repro_torch.core.fdsvrg._lazy_inner_epoch`); it is
    block-local, so the metering is the dense epoch's.  Multi-output
    labels (k > 1) run the dense epoch only (no ``lazy_updates``, as in
    the reference).  On the kernel route they run as k scalar kernel-path
    snapshots and epochs over the one sample stream and step mask, each
    column bit for bit its scalar run, so a card run repeats bit for bit
    (the reference raises there; its multi-output is the plain ``vmap``).
    """

    use_kernels: bool = True
    lazy_updates: str | None = None

    name = "svrg"
    supports_recovery = True
    supports_checkpoint = True
    supports_multi_output = True
    supports_option_ii = True

    def validate(self, ctx: RuleContext) -> None:
        super().validate(ctx)
        _check_lazy(self.lazy_updates)
        _check_kernel_dtype(ctx.dtype, self.use_kernels)
        if ctx.num_outputs > 1 and self.lazy_updates:
            raise ValueError(
                "multi-output labels run the dense inner step only: "
                "lazy_updates has no trailing-k form "
                f"(got k={ctx.num_outputs})"
            )

    def default_abort(self, ctx: RuleContext) -> Callable | None:
        return _default_fd_abort(ctx.n * ctx.num_outputs, ctx.nnz, ctx.q)

    def build_snapshot(self, ctx: RuleContext) -> Callable:
        if ctx.num_outputs == 1 or not self.use_kernels:
            return _snapshot_hook(ctx, self.use_kernels)
        cols, loss = _columns(ctx), ctx.loss

        def snapshot(w):
            zs, ss = zip(*(_full_grad_blocks(col, w[:, j].contiguous(), loss, True)
                           for j, col in enumerate(cols)))
            return torch.stack(zs, dim=1), torch.stack(ss, dim=1)

        return snapshot

    def build_epoch(self, ctx: RuleContext) -> Callable:
        bd, cfg, backend, loss, reg = (
            ctx.block_data, ctx.cfg, ctx.backend, ctx.loss, ctx.reg,
        )
        use_kernels, lazy_updates = self.use_kernels, self.lazy_updates
        corrections = _lazy_corrections(bd, ctx.n, ctx.u, lazy_updates)
        n, u, nnz, q, k = ctx.n, ctx.u, ctx.nnz, ctx.q, ctx.num_outputs
        cols = _columns(ctx) if k > 1 and use_kernels else None

        def epoch(t, rng, w, z_data, s0, eta_scale=1.0):
            # Full-gradient phase (Alg 1 lines 3-5): account the snapshot
            # gradient this outer iteration consumes (k margin vectors ride
            # one tree).
            if backend is not None:
                backend.meter_tree(payload=n * k)
                backend.charge_cost(COSTS.fd_fullgrad(n=n, nnz=nnz, q=q, k=k))
            eta = cfg.eta * eta_scale
            with span("rt/draw"):
                samples = draw_samples(rng, n, cfg.inner_steps, u)
                mask = option_mask(rng, cfg.inner_steps, cfg.option)
            if lazy_updates is not None:
                w = _lazy_inner_epoch(
                    bd, w, z_data, s0, samples, eta, mask, corrections, loss, reg,
                    use_kernels, lazy_updates,
                )
            elif cols is not None:
                w = torch.stack([
                    _inner_epoch(col, w[:, j].contiguous(), z_data[:, j].contiguous(),
                                 s0[:, j].contiguous(), samples, eta, mask, loss, reg, True)
                    for j, col in enumerate(cols)
                ], dim=1)
            else:
                w = _inner_epoch(
                    bd, w, z_data, s0, samples, eta, mask, loss, reg, use_kernels
                )
            # Inner-loop communication (Alg 1 lines 9-11): one tree round
            # per mini-batch of u*k margins; M steps, in aggregate.
            if backend is not None:
                backend.meter_tree(payload=u * k, steps=cfg.inner_steps)
                backend.charge_cost(
                    COSTS.fd_inner_step(nnz=nnz, q=q, u=u, k=k),
                    steps=cfg.inner_steps,
                )
            return w

        return epoch

    def build_evaluate(self, ctx: RuleContext) -> Callable:
        if ctx.num_outputs == 1:
            return super().build_evaluate(ctx)
        labels, loss, reg, eta, k = (
            ctx.labels, ctx.loss, ctx.reg, ctx.cfg.eta, ctx.num_outputs,
        )

        def evaluate(w, z_data, s0):
            # Mean-per-output objective: the data term averages over all
            # N*k margins, so g(w) is divided by k to match.
            obj = float(torch.mean(loss.value(s0, labels)) + reg.value(w) / k)
            return obj, optimality_norm(z_data, w, reg, eta)

        return evaluate


# ---------------------------------------------------------------------------
# FD-SAGA: replicated scalar gradient table (n floats, never d)
# ---------------------------------------------------------------------------


def _saga_inner_epoch(
    block_data: BlockCSR,
    w0: torch.Tensor,
    z: torch.Tensor,  # the table's running mean (1/n) sum_i alpha_i x_i
    alpha: torch.Tensor,  # float[n] per-sample margin-derivative table
    samples: np.ndarray,  # int32[M, u]
    eta: float,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    use_kernels: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """M FD-SAGA steps on the block-local layout; returns (w, z) and
    updates ``alpha`` in place (and, on the kernel path, ``z``).

    Per step: the sampled margins the feature-distributed way (per-block
    partials summed in tree order), ``delta = dl(s_m, y) - alpha[ids]``,
    the direction ``scatter(delta / u * x) + z + grad g_smooth`` followed
    by the prox (the SVRG step's formula: one ``prox_update`` launch a
    block on the kernel path), then the table and its mean.  Duplicate
    draws inside one mini-batch count toward the direction but only their
    first occurrence updates the mean, so ``z == (1/n) sum_i alpha_i x_i``
    holds at every step.  On the kernel path the mean's update ``z +
    scatter(coef_tab * x)`` is one ``fused_update`` launch a block, in
    place: its ``w - eta * ((g + z') + lam * w)`` at ``w = z``, ``z' = 0``,
    ``lam = 0`` and ``eta = -1`` is ``z + g`` bit for bit, each id's terms
    added in flat order.  The first-occurrence masks and the ids come from
    the host once an epoch.
    """
    bd = block_data
    device, dtype = w0.device, w0.dtype
    q, n = bd.num_blocks, bd.num_instances
    m_total, u = samples.shape
    bounds = _bounds(bd.block_dims)
    ids_all = _to_device(samples.astype(np.int64), device)
    first = samples[:, :, None] == samples[:, None, :]
    first_all = _to_device(np.argmax(first, axis=2) == np.arange(u), device)
    y_all = bd.labels[ids_all]
    u_t = torch.full((), float(u), dtype=dtype, device=device)
    n_t = torch.full((), float(n), dtype=dtype, device=device)
    eta32 = float(np.float32(eta))
    if use_kernels:
        w = w0.clone()
        rows_buf = ops.step_rows(bd, u)
        zeros = torch.zeros_like(w0)
        zero_blocks = [zeros[bounds[l]:bounds[l + 1]] for l in range(q)]
    else:
        w = w0
        eta_t = torch.full((), eta32, dtype=dtype, device=device)
    w_blocks = [w[bounds[l]:bounds[l + 1]] for l in range(q)]
    z_blocks = [z[bounds[l]:bounds[l + 1]] for l in range(q)]
    for m in range(m_total):
        ids = ids_all[m]
        if use_kernels:
            s_m, rows, _ = ops.step_margins(bd, ids, w, out=rows_buf)
        else:
            rows = _gather_rows(bd, ids)
            s_m = tree_order_sum([local_margins(*rows[l], w_blocks[l]) for l in range(q)])
        a_new = loss.dvalue(s_m, y_all[m])
        delta = a_new - alpha[ids]
        coef_dir = delta / u_t
        coef_tab = torch.where(first_all[m], delta, 0.0) / n_t
        for l in range(q):
            idx, val = rows[l]
            if use_kernels:
                ops.fused_block_prox_update(
                    w_blocks[l], idx, val, coef_dir, z_blocks[l], eta32, lam=reg.smooth_lam,
                    lam1=reg.prox_l1, lam2=reg.prox_l2, out=w_blocks[l],
                )
                ops.fused_block_update(z_blocks[l], idx, val, coef_tab, zero_blocks[l], -1.0,
                                       lam=0.0, out=z_blocks[l])
            else:
                dim = bd.block_dims[l]
                g = local_scatter(idx, val, coef_dir, dim) + z_blocks[l] \
                    + reg.smooth_grad(w_blocks[l])
                w_blocks[l] = reg.prox(w_blocks[l] - eta_t * g, eta_t)
                z_blocks[l] = z_blocks[l] + local_scatter(idx, val, coef_tab, dim)
        alpha.index_put_((ids,), a_new)
    if use_kernels:
        return w, z
    if q == 1:
        return w_blocks[0], z_blocks[0]
    return torch.cat(w_blocks), torch.cat(z_blocks)


@dataclasses.dataclass(frozen=True)
class SAGARule(UpdateRule):
    """Feature-distributed SAGA (Distributed SAGA, arXiv 1705.10405).

    State carry: the n-float margin-derivative table alpha and its running
    mean z, taken from the outer-0 snapshot (``alpha = dl(s0, y)`` and ``z
    = z_data`` are exactly its content), metered once
    (:meth:`CostModel.fd_saga_init`).  Later snapshots are for reporting
    only and are not metered; each of the M steps meters one u-payload
    tree (:meth:`CostModel.fd_saga_step`).
    """

    use_kernels: bool = True

    name = "fd_saga"

    def validate(self, ctx: RuleContext) -> None:
        super().validate(ctx)
        _check_kernel_dtype(ctx.dtype, self.use_kernels)

    def build_snapshot(self, ctx: RuleContext) -> Callable:
        return _snapshot_hook(ctx, self.use_kernels)

    def build_epoch(self, ctx: RuleContext) -> Callable:
        bd, cfg, backend, loss, reg = (
            ctx.block_data, ctx.cfg, ctx.backend, ctx.loss, ctx.reg,
        )
        n, u, nnz, q = ctx.n, ctx.u, ctx.nnz, ctx.q
        use_kernels = self.use_kernels
        state: dict = {}

        def epoch(t, rng, w, z_data, s0, eta_scale=1.0):
            if "alpha" not in state:
                # Outer 0: adopt the harness snapshot as the table; z_data
                # IS (1/n) sum_i dl(s0_i, y_i) x_i.
                state["alpha"] = loss.dvalue(s0, bd.labels)
                state["z"] = z_data.clone()
                if backend is not None:
                    backend.meter_tree(payload=n)
                    backend.charge_cost(COSTS.fd_saga_init(n=n, nnz=nnz, q=q))
            samples = draw_samples(rng, n, cfg.inner_steps, u)
            w, state["z"] = _saga_inner_epoch(
                bd, w, state["z"], state["alpha"], samples, cfg.eta * eta_scale, loss, reg,
                use_kernels,
            )
            if backend is not None:
                backend.meter_tree(payload=u, steps=cfg.inner_steps)
                backend.charge_cost(
                    COSTS.fd_saga_step(nnz=nnz, q=q, u=u), steps=cfg.inner_steps
                )
            return w

        return epoch


# ---------------------------------------------------------------------------
# FD-BCD: distributed block coordinate descent (Mahajan et al., 1405.4544)
# ---------------------------------------------------------------------------


def _bcd_epoch(
    block_data: BlockCSR,
    w0: torch.Tensor,
    s0: torch.Tensor,  # the margins at w0 (the snapshot's)
    eta: float,
    cursor: int,  # the first step's block
    steps: int,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    indexes: list | None,  # each block's scatter_index (kernel path)
) -> torch.Tensor:
    """``steps`` BCD steps, block ``(cursor + m) mod q`` at step m: the
    block takes a prox-gradient step against the full data gradient
    restricted to it, ``coeffs = dl(s, y) / N`` scattered over all N rows,
    then the margins take the block update's delta.  With ``indexes`` (the
    kernel path) the coefficients, the scatter and the delta's margins are
    one launch each (``logistic_grad``'s snapshot coefficients,
    ``block_scatter`` over the block's index, ``sparse_margin``); the prox
    is elementwise torch ops on both paths.  ``w0`` is copied once; no
    sample is drawn."""
    bd = block_data
    q, n = bd.num_blocks, bd.num_instances
    bounds = _bounds(bd.block_dims)
    eta_t = torch.full((), float(np.float32(eta)), dtype=w0.dtype, device=w0.device)
    w, s = w0.clone(), s0
    for m in range(steps):
        l = (cursor + m) % q
        idx, val = bd.block(l)
        dim = bd.block_dims[l]
        w_blk = w[bounds[l]:bounds[l + 1]]
        if indexes is not None:
            g = ops.block_scatter(idx, val, ops.snapshot_coef(bd, s, loss), dim, indexes[l])
        else:
            g = local_scatter(idx, val, snapshot_coef_plain(s, bd.labels, n, loss.dvalue), dim)
        w_new = reg.prox(w_blk - eta_t * (g + reg.smooth_grad(w_blk)), eta_t)
        step = w_new - w_blk
        s = s + (ops.sparse_margins(idx, val, step) if indexes is not None
                 else local_margins(idx, val, step))
        w_blk.copy_(w_new)
    return w


@dataclasses.dataclass(frozen=True)
class BCDRule(UpdateRule):
    """Distributed block coordinate descent (Mahajan et al., arXiv
    1405.4544) on the same BlockCSR column partition as FD-SVRG.

    State carry: the active-block cursor (it survives across outers, so M
    need not be a multiple of q) and the maintained margins, re-seeded
    each epoch from the snapshot's ``s0``.  Each step meters one N-payload
    tree (the block's margin delta reaches every worker); the sample
    stream is untouched.
    """

    use_kernels: bool = True

    name = "fd_bcd"

    def validate(self, ctx: RuleContext) -> None:
        super().validate(ctx)
        _check_kernel_dtype(ctx.dtype, self.use_kernels)

    def build_snapshot(self, ctx: RuleContext) -> Callable:
        return _snapshot_hook(ctx, self.use_kernels)

    def build_epoch(self, ctx: RuleContext) -> Callable:
        bd, cfg, backend, loss, reg = (
            ctx.block_data, ctx.cfg, ctx.backend, ctx.loss, ctx.reg,
        )
        n, nnz, q = ctx.n, ctx.nnz, ctx.q
        indexes = [scatter_index(*bd.block(l), bd.block_dims[l]) for l in range(q)] \
            if self.use_kernels else None
        state = {"cursor": 0}

        def epoch(t, rng, w, z_data, s0, eta_scale=1.0):
            w = _bcd_epoch(bd, w, s0, cfg.eta * eta_scale, state["cursor"], cfg.inner_steps,
                           loss, reg, indexes)
            state["cursor"] = (state["cursor"] + cfg.inner_steps) % q
            if backend is not None:
                backend.meter_tree(payload=n, steps=cfg.inner_steps)
                backend.charge_cost(
                    COSTS.fd_bcd_step(n=n, nnz=nnz, q=q), steps=cfg.inner_steps
                )
            return w

        return epoch


RULES = {
    "svrg": SVRGRule,
    "fd_saga": SAGARule,
    "fd_bcd": BCDRule,
}

__all__ = [
    "BCDRule",
    "RULES",
    "RuleContext",
    "SAGARule",
    "SVRGRule",
    "UpdateRule",
    "make_context",
    "run_with_rule",
]
