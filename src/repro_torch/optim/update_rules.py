"""The update-rule layer: one outer-loop harness, pluggable inner steps.

Port of ``repro.optim.update_rules`` for the main path: the context, the
rule protocol, :func:`run_with_rule`, and :class:`SVRGRule` for a scalar
output (k = 1), dense or lazy.  Multi-output ``w`` and the SAGA / BCD
rules (ROADMAP queue 1, item 6) come with a later slice; ``[N, k > 1]``
labels raise ``NotImplementedError`` here.

Import direction, as in the reference: this module imports the building
blocks from :mod:`repro_torch.core.fdsvrg`; the drivers there import this
module inside their function bodies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import (
    RecoveryPolicy,
    RunResult,
    draw_samples,
    make_same_iterate_eval,
    option_mask,
    resolve_init_w,
    run_outer_loop,
)
from repro_torch.core.fdsvrg import (
    SVRGConfig,
    _check_lazy,
    _default_fd_abort,
    _full_grad_blocks,
    _inner_epoch,
    _lazy_corrections,
    _lazy_inner_epoch,
)
from repro_torch.data.block_csr import BlockCSR
from repro_torch.dist import COSTS, Collectives


@dataclasses.dataclass(frozen=True)
class RuleContext:
    """One run's immutable inputs.  ``backend=None`` is the serial
    (unmetered) path; ``num_outputs`` is the output width k (1 here)."""

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
    """Build a :class:`RuleContext`.  A ``[N, 1]`` label matrix is squeezed
    onto the scalar path; ``[N, k > 1]`` labels raise (not ported yet)."""
    labels = block_data.labels
    if labels.dim() == 2:
        if labels.shape[1] != 1:
            raise NotImplementedError(
                f"multi-output labels [N, {labels.shape[1]}] are not ported yet "
                "(ROADMAP queue 1, item 6)"
            )
        block_data = dataclasses.replace(block_data, labels=labels[:, 0])
    if backend is not None and backend.q != block_data.num_blocks:
        raise ValueError(
            f"backend has q={backend.q} workers but block_data has "
            f"{block_data.num_blocks} blocks"
        )
    return RuleContext(
        block_data=block_data, loss=loss, reg=reg, cfg=cfg, backend=backend
    )


class UpdateRule:
    """Base class: a rule owns its state carry, direction and metering.

    ``build_snapshot`` / ``build_epoch`` / ``build_evaluate`` are called
    once per run and return the harness hooks.
    """

    name: str = "update_rule"
    supports_recovery: bool = False
    supports_option_ii: bool = False

    def validate(self, ctx: RuleContext) -> None:
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
        return resolve_init_w(init_w, ctx.block_data.dim, ctx.dtype, ctx.device)

    def default_abort(self, ctx: RuleContext) -> Callable | None:
        return None


def run_with_rule(
    rule: UpdateRule,
    ctx: RuleContext,
    *,
    init_w=None,
    recovery: RecoveryPolicy | None = None,
) -> RunResult:
    """Wire one rule into the outer-loop harness and run it."""
    rule.validate(ctx)
    if recovery is not None and not rule.supports_recovery:
        raise ValueError(f"rule {rule.name!r} does not support epoch-abort recovery")
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
    )


@dataclasses.dataclass(frozen=True)
class SVRGRule(UpdateRule):
    """Prox-SVRG: the snapshot pair (z, s0) is the whole state.

    ``use_kernels`` (default ``True``) runs the hot paths through
    :mod:`repro_torch.kernels.ops`.  ``lazy_updates`` ("exact" | "proba")
    swaps the dense inner epoch for the delayed-decay one
    (:func:`~repro_torch.core.fdsvrg._lazy_inner_epoch`); it is
    block-local, so the metering is the dense epoch's.
    """

    use_kernels: bool = True
    lazy_updates: str | None = None

    name = "svrg"
    supports_recovery = True
    supports_option_ii = True

    def validate(self, ctx: RuleContext) -> None:
        super().validate(ctx)
        _check_lazy(self.lazy_updates)

    def default_abort(self, ctx: RuleContext) -> Callable | None:
        return _default_fd_abort(ctx.n, ctx.nnz, ctx.q)

    def build_snapshot(self, ctx: RuleContext) -> Callable:
        bd, loss, use_kernels = ctx.block_data, ctx.loss, self.use_kernels

        def snapshot(w):
            return _full_grad_blocks(bd, w, loss, use_kernels)

        return snapshot

    def build_epoch(self, ctx: RuleContext) -> Callable:
        bd, cfg, backend, loss, reg = (
            ctx.block_data, ctx.cfg, ctx.backend, ctx.loss, ctx.reg,
        )
        use_kernels, lazy_updates = self.use_kernels, self.lazy_updates
        corrections = _lazy_corrections(bd, ctx.n, ctx.u, lazy_updates)
        n, u, nnz, q = ctx.n, ctx.u, ctx.nnz, ctx.q

        def epoch(t, rng, w, z_data, s0, eta_scale=1.0):
            # Full-gradient phase (Alg 1 lines 3-5): account the snapshot
            # gradient this outer iteration consumes.
            if backend is not None:
                backend.meter_tree(payload=n)
                backend.charge_cost(COSTS.fd_fullgrad(n=n, nnz=nnz, q=q))
            eta = cfg.eta * eta_scale
            samples = draw_samples(rng, n, cfg.inner_steps, u)
            mask = option_mask(rng, cfg.inner_steps, cfg.option)
            if lazy_updates is not None:
                w = _lazy_inner_epoch(
                    bd, w, z_data, s0, samples, eta, mask, corrections, loss, reg,
                    use_kernels, lazy_updates,
                )
            else:
                w = _inner_epoch(
                    bd, w, z_data, s0, samples, eta, mask, loss, reg, use_kernels
                )
            # Inner-loop communication (Alg 1 lines 9-11): one tree round
            # per mini-batch of u margins; M steps, in aggregate.
            if backend is not None:
                backend.meter_tree(payload=u, steps=cfg.inner_steps)
                backend.charge_cost(
                    COSTS.fd_inner_step(nnz=nnz, q=q, u=u),
                    steps=cfg.inner_steps,
                )
            return w

        return epoch


__all__ = [
    "RuleContext",
    "SVRGRule",
    "UpdateRule",
    "make_context",
    "run_with_rule",
]
