"""FD-SVRG (paper Algorithm 1) and serial SVRG (paper Algorithm 2).

Port of ``repro.core.fdsvrg``:

* :func:`run_serial_svrg` — Algorithm 2 (Johnson & Zhang), options I/II,
  on the q = 1 block layout.
* :func:`run_fdsvrg` — Algorithm 1 at simulation level: margins are the
  tree-order sum of per-block partials, communication is metered with the
  paper's accounting through a ``Collectives`` backend.
* :func:`fdsvrg_worker_simulation` — the explicit q-worker object-level
  simulation (each worker touches only its own ``w^(l)`` and rows): the
  executable spec.

The first two are thin wrappers over
:class:`repro_torch.optim.update_rules.SVRGRule` running under
:func:`repro_torch.core.driver.run_outer_loop`.  The rule's hooks are
here: :func:`_full_grad_blocks` (snapshot), and :func:`_inner_epoch` or,
with ``lazy_updates="exact" | "proba"``, :func:`_lazy_inner_epoch`
(epoch; the reference's ``lax.scan`` becomes a Python loop that never
waits on the device).

``use_kernels=True`` (the default) routes the gather-margin (with the
row gathers and the tree sum: one launch a step and one a snapshot for
all q blocks), the loss coefficients (one launch a step and one a
snapshot), the snapshot scatter, the fused scatter + update + prox and
the lazy steps (the catch-up one launch a step for all q blocks, the
flush one an epoch) through :mod:`repro_torch.kernels.ops`: the CUDA
kernels on a CUDA device, their plain PyTorch versions on the CPU.
``use_kernels=False`` is the plain path written like the reference's jnp
oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import (
    CheckpointPolicy,
    RecoveryPolicy,
    RunResult,
    draw_samples,
    make_same_iterate_eval,
    option_mask,
    resolve_device,
    resolve_init_w,
    run_outer_loop,
)
from repro_torch.core.partition import FeaturePartition, balanced
from repro_torch.data.block_csr import BlockCSR, local_margins, local_scatter
from repro_torch.data.sparse import PaddedCSR, margins_rows, scatter_grad
from repro_torch.dist import COSTS, ClusterModel, Collectives, SimBackend, tree_order_sum
from repro_torch.dist.meter import tree_rounds
from repro_torch.kernels import lazy_update, logistic_grad, ops


@dataclasses.dataclass(frozen=True)
class SVRGConfig:
    eta: float
    inner_steps: int  # M; paper sets M = #instances held per worker (= N for FD)
    outer_iters: int
    batch_size: int = 1  # u, the mini-batch trick of §4.4.1
    option: str = "I"  # paper proves Option I (Theorem 1) and uses it
    seed: int = 0

    def __post_init__(self) -> None:
        if self.option not in ("I", "II"):
            raise ValueError(f"option must be 'I' or 'II', got {self.option!r}")
        if self.batch_size < 1:
            raise ValueError("batch_size >= 1 required")


# ---------------------------------------------------------------------------
# Objective / full gradient on the global layout
# ---------------------------------------------------------------------------


def objective(
    data: PaddedCSR,
    w: torch.Tensor,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
) -> float:
    s = margins_rows(data.indices, data.values, w)
    return float(torch.mean(loss.value(s, data.labels)) + reg.value(w))


def full_gradient(
    data: PaddedCSR, w: torch.Tensor, loss: losses_lib.MarginLoss
) -> tuple[torch.Tensor, torch.Tensor]:
    """Data part of the full gradient plus the margins s0 = w^T x_i."""
    s0 = margins_rows(data.indices, data.values, w)
    coeffs = logistic_grad.snapshot_coef_plain(s0, data.labels, data.num_instances, loss.dvalue)
    return scatter_grad(data.indices, data.values, coeffs, w.shape[0]), s0


# ---------------------------------------------------------------------------
# Block-local hot paths
# ---------------------------------------------------------------------------


def _bounds(block_dims: tuple[int, ...]) -> tuple[int, ...]:
    b = [0]
    for d in block_dims:
        b.append(b[-1] + d)
    return tuple(b)


def _gather_rows(bd: BlockCSR, ids: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Every block's sampled rows (the plain path's torch gathers)."""
    return [(bd.indices[l][ids], bd.values[l][ids]) for l in range(bd.num_blocks)]


def _snapshot_scatter(bd: BlockCSR, coeffs, use_kernels: bool) -> torch.Tensor:
    """Every block's scatter of the full gradient (Alg 1 line 5), the q
    blocks' z concatenated: one kernel launch with ``use_kernels``, else
    each block's ``local_scatter``."""
    if use_kernels:
        return ops.snapshot_scatter(bd, coeffs)
    z_blocks = [
        local_scatter(*bd.block(l), coeffs, bd.block_dims[l]) for l in range(bd.num_blocks)
    ]
    return torch.cat(z_blocks) if len(z_blocks) > 1 else z_blocks[0]


def _full_grad_blocks(
    block_data: BlockCSR,
    w: torch.Tensor,
    loss: losses_lib.MarginLoss,
    use_kernels: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Feature-decomposed full gradient: per-block partial margins summed
    in tree order (Alg 1 lines 3-4), then a block-local scatter (line 5).
    Returns the concatenated z and the margins s0."""
    bd = block_data
    if use_kernels:
        s0 = ops.snapshot_margins(bd, w)
        coeffs = ops.snapshot_coef(bd, s0, loss)
    else:
        bounds = _bounds(bd.block_dims)
        s0 = tree_order_sum([
            local_margins(bd.indices[l], bd.values[l], w[bounds[l]:bounds[l + 1]])
            for l in range(bd.num_blocks)
        ])
        coeffs = logistic_grad.snapshot_coef_plain(s0, bd.labels, bd.num_instances,
                                                   loss.dvalue)
    return _snapshot_scatter(bd, coeffs, use_kernels), s0


def _default_fd_abort(n: int, nnz: int, q: int):
    """The default ``RecoveryPolicy.on_abort`` for the FD drivers: one
    extra full-gradient phase, metered under its own ``"abort"`` kind."""

    def on_abort(backend):
        if backend.q > 1:
            backend.p2p(2 * backend.q * n, "abort", rounds=tree_rounds(backend.q))
        backend.charge_cost(COSTS.fd_fullgrad(n=n, nnz=nnz, q=q))

    return on_abort


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without making the host wait (pinned
    staging + non-blocking copy on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# Inner epoch (shared by the serial and the simulated-FD paths)
# ---------------------------------------------------------------------------


def _inner_epoch(
    block_data: BlockCSR,
    w0: torch.Tensor,
    z_data: torch.Tensor,
    s0: torch.Tensor,
    samples: np.ndarray,  # int32[M, u]
    eta: float,
    step_mask: np.ndarray,  # float32[M] (1 = apply update; Option II masks the tail)
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    use_kernels: bool,
) -> torch.Tensor:
    """M proximal variance-reduced updates on the block-local layout.

    Each step gathers the u sampled rows of every block, sums the q
    partial margins in tree order, and applies
    ``w <- prox_{eta*g}(w - eta * (grad_vr + z + smooth_grad g))`` block by
    block.  The step size is ``float32(eta) * mask[m]``, taken on the host
    from numpy, and the sample ids go to the device once per epoch, so no
    step makes the host wait for the device.  On the kernel path one
    launch gives the margins and the gathered rows of all q blocks, one
    the step's coefficients, and each block's update writes a copy of
    ``w0`` in place.
    """
    bd = block_data
    device = w0.device
    q = bd.num_blocks
    m_total, u = samples.shape
    bounds = _bounds(bd.block_dims)
    eta_steps = np.float32(eta) * step_mask.astype(np.float32)  # float32[M]
    ids_all = _to_device(samples.astype(np.int64), device)
    u_t = torch.full((), float(u), dtype=w0.dtype, device=device)
    lams = (reg.smooth_lam, reg.prox_l1, reg.prox_l2)
    if use_kernels:
        w = w0.clone()
        rows_buf = ops.step_rows(bd, u)
    else:
        w = w0
        eta_dev = _to_device(eta_steps, device)
    w_blocks = [w[bounds[l]:bounds[l + 1]] for l in range(q)]
    z_blocks = [z_data[bounds[l]:bounds[l + 1]] for l in range(q)]
    for m in range(m_total):
        ids = ids_all[m]
        if use_kernels:
            s_m, rows, _ = ops.step_margins(bd, ids, w, out=rows_buf)
            coef = ops.step_coef(bd, ids, s_m, s0, u_t, loss)
        else:
            rows = _gather_rows(bd, ids)
            # Pairwise summation mirroring Figure 5 (the FD == serial contract).
            s_m = tree_order_sum([local_margins(*rows[l], w_blocks[l]) for l in range(q)])
            coef = logistic_grad.step_coef_plain(s_m, ids, bd.labels, s0, u_t, loss.dvalue)
        for l in range(q):
            idx, val = rows[l]
            if use_kernels:
                ops.fused_block_prox_update(
                    w_blocks[l], idx, val, coef, z_blocks[l], float(eta_steps[m]),
                    lam=lams[0], lam1=lams[1], lam2=lams[2], out=w_blocks[l],
                )
            else:
                eta_m = eta_dev[m]
                g = local_scatter(idx, val, coef, bd.block_dims[l])
                g = g + z_blocks[l] + reg.smooth_grad(w_blocks[l])
                w_blocks[l] = reg.prox(w_blocks[l] - eta_m * g, eta_m)
    if use_kernels:
        return w
    return torch.cat(w_blocks) if q > 1 else w_blocks[0]


def _check_kernel_dtype(dtype: torch.dtype, use_kernels: bool) -> None:
    """The kernels take float32: other data on the kernel path raises
    (``use_kernels=False`` keeps the data's dtype, as the reference does)."""
    if use_kernels and dtype != torch.float32:
        raise ValueError(
            f"use_kernels=True runs float32 data only, got {dtype}; pass "
            "use_kernels=False to keep it"
        )


# ---------------------------------------------------------------------------
# Lazy (delayed-decay) inner epoch — O(u * nnz_l) per step
# ---------------------------------------------------------------------------


def _check_lazy(lazy_updates: str | None) -> None:
    if lazy_updates not in (None, "exact", "proba"):
        raise ValueError(
            "lazy_updates must be None, 'exact', or 'proba', got "
            f"{lazy_updates!r}"
        )


def _lazy_lams(reg: losses_lib.Regularizer) -> tuple[float, float, float]:
    """(smooth_lam, prox_l1, prox_l2) of the lazy kernels and the
    simulation helpers."""
    return (reg.smooth_lam, reg.prox_l1, reg.prox_l2)


def _lazy_corrections(
    block_data: BlockCSR, n: int, u: int, lazy_updates: str | None
) -> torch.Tensor | None:
    """Concatenated per-feature step corrections (probabilistic variant)."""
    if lazy_updates != "proba":
        return None
    blocks = [
        ops.step_corrections(block_data.nnz_col_block(l), n, u)
        for l in range(block_data.num_blocks)
    ]
    return torch.cat(blocks) if len(blocks) > 1 else blocks[0]


def _lazy_inner_epoch(
    block_data: BlockCSR,
    w0: torch.Tensor,
    z_data: torch.Tensor,
    s0: torch.Tensor,
    samples: np.ndarray,  # int32[M, u]
    eta: float,
    step_mask: np.ndarray,  # float32[M]; a monotone prefix of ones (options I/II)
    corrections: torch.Tensor | None,  # [d] step corrections (proba) or None
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    use_kernels: bool,
    variant: str,  # "exact" | "proba"
) -> torch.Tensor:
    """The inner epoch of :func:`_inner_epoch` with O(u * nnz_l) work per
    block and step:

    * exact — catch up the touched features (replay their deferred
      steps), read the margins from the caught-up block, apply the dense
      update at the touched features only, and at epoch end replay every
      feature's remaining steps (flush): the result equals
      :func:`_inner_epoch`'s bit for bit;
    * proba — touched features only, the decay scaled by the per-feature
      corrections; no counters, no flush.

    Both read only block-local state, so the metered schedule is the dense
    one.  ``w0`` is copied once; the steps update the copy in place (the
    lazy kernels and their plain versions work in place).  On the kernel
    path a step's catch-up is one launch for all q blocks, and so are its
    margins with the gathered rows; its coefficients are one launch, and
    the epoch's flush one over the whole width.  Samples, mask
    and ``stop = sum(mask)`` come from numpy on the host, so on the kernel
    path no step waits on the device.  ``use_kernels=False`` mirrors the
    reference's jnp closures; its replay reads ``max(k_active)`` from the
    device at every catch-up.
    """
    bd = block_data
    device = w0.device
    q = bd.num_blocks
    m_total, u = samples.shape
    bounds = _bounds(bd.block_dims)
    exact = variant == "exact"
    eta32 = float(np.float32(eta))
    eta_steps = np.float32(eta) * step_mask.astype(np.float32)  # float32[M]
    # Option masks are 1s then 0s: a gap is `active` replays + <= 1 masked.
    stop = int(step_mask.sum())
    ids_all = _to_device(samples.astype(np.int64), device)
    u_t = torch.full((), float(u), dtype=w0.dtype, device=device)
    smooth_lam, lam1, lam2 = _lazy_lams(reg)
    w = w0.clone()
    w_blocks = [w[bounds[l]:bounds[l + 1]] for l in range(q)]  # views of w
    z_blocks = [z_data[bounds[l]:bounds[l + 1]] for l in range(q)]
    if exact:
        last = torch.zeros(w.shape, dtype=torch.int32, device=device)
        last_blocks = [last[bounds[l]:bounds[l + 1]] for l in range(q)]
    else:
        corr_blocks = [corrections[bounds[l]:bounds[l + 1]] for l in range(q)]
    if use_kernels:
        rows_buf = ops.step_rows(bd, u)
    else:
        eta_dev = _to_device(eta_steps, device)
        eta_full = torch.full((), eta32, dtype=w0.dtype, device=device)

    def plain_replay(wl, zl, k_active, has_masked):
        # The untouched dense step (g = the scatter's +0.0 base), replayed
        # k_active times plus at most one masked step.
        def one(cur, eta_i):
            g = 0.0 + zl + smooth_lam * cur
            return reg.prox(cur - eta_i * g, eta_i)

        for i in range(int(k_active.max()) if k_active.numel() else 0):
            wl = torch.where(i < k_active, one(wl, eta_full), wl)
        return torch.where(has_masked, one(wl, eta_full * 0.0), wl)

    def plain_catchup(w_blk, last_blk, z_blk, idx, m):
        flat = idx.reshape(-1)
        ll = last_blk[flat]
        k_active = torch.clamp_min(min(stop, m) - ll, 0)
        has_masked = (m - ll) > k_active
        w_blk[flat] = plain_replay(w_blk[flat], z_blk[flat], k_active, has_masked)
        last_blk[flat] = m + 1

    def plain_touch(w_blk, idx, val, coef, z_blk, eta_m):
        # First-occurrence accumulation: the dense scatter's order (the
        # bit-identity contract pins it).
        flat = idx.reshape(-1)
        contrib = (val * coef[..., None]).reshape(-1)
        first = lazy_update.first_occurrence(flat)
        g = torch.zeros_like(contrib).index_add_(0, first, contrib)
        wl = w_blk[flat]
        g = g + z_blk[flat] + smooth_lam * wl
        w_blk[flat] = reg.prox(wl - eta_m * g, eta_m)[first]

    def plain_flush(w_blk, last_blk, z_blk):
        k_active = torch.clamp_min(min(stop, m_total) - last_blk, 0)
        has_masked = (m_total - last_blk) > k_active
        w_blk.copy_(plain_replay(w_blk, z_blk, k_active, has_masked))

    def plain_proba(w_blk, idx, val, coef, z_blk, corr_blk, eta_m):
        # Masked column-sum dedup: every lane of a duplicated id gets the
        # same summed contribution (no bit contract here, as in the
        # reference).
        flat = idx.reshape(-1)
        contrib = (val * coef[..., None]).reshape(-1)
        eq = flat[:, None] == flat[None, :]
        g = torch.sum(torch.where(eq, contrib[:, None], 0.0), dim=0)
        wl = w_blk[flat]
        cl = corr_blk[flat]
        v = wl - eta_m * (g + cl * (z_blk[flat] + smooth_lam * wl))
        if reg.name in ("l1", "elastic_net"):
            v = losses_lib.soft_threshold(v, eta_m * reg.lam * cl)
            if reg.lam2:
                v = v / (1.0 + eta_m * reg.lam2 * cl)
        w_blk[flat] = v

    for m in range(m_total):
        ids = ids_all[m]
        # The margins gather only touched ids, which the catch-up first
        # materializes: coef is the dense epoch's, bit for bit.
        if use_kernels:
            if exact:
                ops.lazy_step_catchup(bd, ids, w, last, z_data, eta32, m, stop,
                                      lam=smooth_lam, lam1=lam1, lam2=lam2)
            s_m, rows, _ = ops.step_margins(bd, ids, w, out=rows_buf)
            coef = ops.step_coef(bd, ids, s_m, s0, u_t, loss)
        else:
            rows = _gather_rows(bd, ids)
            if exact:
                for l in range(q):
                    plain_catchup(w_blocks[l], last_blocks[l], z_blocks[l], rows[l][0], m)
            s_m = tree_order_sum([local_margins(*rows[l], w_blocks[l]) for l in range(q)])
            coef = logistic_grad.step_coef_plain(s_m, ids, bd.labels, s0, u_t, loss.dvalue)
        for l in range(q):
            idx, val = rows[l]
            if use_kernels and exact:
                ops.lazy_block_touch_update(
                    w_blocks[l], idx, val, coef, z_blocks[l], float(eta_steps[m]),
                    lam=smooth_lam, lam1=lam1, lam2=lam2,
                )
            elif use_kernels:
                ops.lazy_block_proba_update(
                    w_blocks[l], idx, val, coef, z_blocks[l], corr_blocks[l],
                    float(eta_steps[m]), lam=smooth_lam, lam1=lam1, lam2=lam2,
                )
            elif exact:
                plain_touch(w_blocks[l], idx, val, coef, z_blocks[l], eta_dev[m])
            else:
                plain_proba(w_blocks[l], idx, val, coef, z_blocks[l], corr_blocks[l],
                            eta_dev[m])
    if exact:
        # Epoch-end flush: snapshots, objectives and meters downstream see
        # the fully materialized iterate.  On the kernel path one launch
        # over the whole width (each feature replays from its own last).
        if use_kernels:
            ops.lazy_block_flush(w, last, z_data, eta32, m_total, stop,
                                 lam=smooth_lam, lam1=lam1, lam2=lam2)
        else:
            for l in range(q):
                plain_flush(w_blocks[l], last_blocks[l], z_blocks[l])
    return w


# ---------------------------------------------------------------------------
# Serial SVRG (Algorithm 2)
# ---------------------------------------------------------------------------


def run_serial_svrg(
    data: PaddedCSR | None,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    *,
    use_kernels: bool = True,
    block_data: BlockCSR | None = None,
    init_w: torch.Tensor | np.ndarray | None = None,
    lazy_updates: str | None = None,
    recovery: RecoveryPolicy | None = None,
    checkpoint: CheckpointPolicy | None = None,
    device: torch.device | str | None = None,
) -> RunResult:
    """Serial SVRG on the q = 1 layout.

    ``use_kernels`` defaults to ``True`` (the reference's default is
    ``False``): on a CUDA device the run goes through the CUDA kernels.
    ``device`` defaults to ``cuda`` and raises when no CUDA device exists;
    pass ``device="cpu"`` for the plain path on the CPU.  ``checkpoint``
    persists and resumes the outer loop (a streamed ``block_data`` runs
    without the global ``PaddedCSR``).
    """
    _check_lazy(lazy_updates)
    device = resolve_device(device)
    if block_data is None:
        if data is None:
            raise ValueError("pass data or a prebuilt block_data")
        block_data = BlockCSR.from_padded(data, balanced(data.dim, 1))
    elif block_data.num_blocks != 1:
        raise ValueError(
            f"serial SVRG runs on the q=1 layout; block_data has "
            f"{block_data.num_blocks} blocks"
        )
    from repro_torch.optim.update_rules import SVRGRule, make_context, run_with_rule

    return run_with_rule(
        SVRGRule(use_kernels=use_kernels, lazy_updates=lazy_updates),
        make_context(block_data.to(device), loss, reg, cfg),
        init_w=init_w,
        recovery=recovery,
        checkpoint=checkpoint,
    )


# ---------------------------------------------------------------------------
# FD-SVRG (Algorithm 1), metered simulation
# ---------------------------------------------------------------------------


def run_fdsvrg(
    data: PaddedCSR | None,
    partition: FeaturePartition,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    cluster: ClusterModel | None = None,
    backend: Collectives | None = None,
    *,
    use_kernels: bool = True,
    block_data: BlockCSR | None = None,
    init_w: torch.Tensor | np.ndarray | None = None,
    lazy_updates: str | None = None,
    recovery: RecoveryPolicy | None = None,
    checkpoint: CheckpointPolicy | None = None,
    device: torch.device | str | None = None,
) -> RunResult:
    """Algorithm 1 with q = partition.num_blocks feature-sharded workers.

    Same update sequence as serial SVRG (margins summed in tree order) on
    the block-local layout, built here or passed as ``block_data``.
    Communication is metered through ``backend`` (default a fresh
    ``SimBackend``) with the §4.5 closed forms:

      outer t:  tree reduce+broadcast of the N-vector  w_t^T D  -> 2qN scalars
      inner m:  tree reduce+broadcast of u margins      -> 2qu scalars

    ``use_kernels`` defaults to ``True`` (the reference's default is
    ``False``); ``device`` defaults to ``cuda`` and raises when no CUDA
    device exists.  ``backend`` may be a ``FaultyBackend`` over a
    ``SimBackend``; ``recovery`` and ``checkpoint`` arm the harness's
    epoch-abort recovery and checkpoint/resume.
    """
    _check_lazy(lazy_updates)
    device = resolve_device(device)
    q = partition.num_blocks
    if backend is None:
        backend = SimBackend(q, cluster)
    elif backend.q != q:
        raise ValueError(
            f"backend has q={backend.q} workers but the partition has "
            f"{q} blocks"
        )
    if block_data is None:
        if data is None:
            raise ValueError("pass data or a prebuilt block_data")
        block_data = BlockCSR.from_padded(data, partition)
    elif block_data.partition.bounds != partition.bounds:
        raise ValueError("block_data was built for a different partition")
    from repro_torch.optim.update_rules import SVRGRule, make_context, run_with_rule

    return run_with_rule(
        SVRGRule(use_kernels=use_kernels, lazy_updates=lazy_updates),
        make_context(block_data.to(device), loss, reg, cfg, backend=backend),
        init_w=init_w,
        recovery=recovery,
        checkpoint=checkpoint,
    )


# ---------------------------------------------------------------------------
# Explicit q-worker simulation (the executable spec): workers only see
# their own blocks
# ---------------------------------------------------------------------------


def _sim_update(w_block, idx, val, coef, z_block, eta_m: float, reg, use_kernels: bool):
    """One worker's dense prox step; ``eta_m`` a float32 host value.  The
    kernel path updates ``w_block`` in place."""
    if use_kernels:
        return ops.fused_block_prox_update(
            w_block, idx, val, coef, z_block, eta_m,
            lam=reg.smooth_lam, lam1=reg.prox_l1, lam2=reg.prox_l2, out=w_block,
        )
    eta_t = torch.full((), eta_m, dtype=w_block.dtype, device=w_block.device)
    g = (
        local_scatter(idx, val, coef, w_block.shape[0])
        + z_block
        + reg.smooth_grad(w_block)
    )
    return reg.prox(w_block - eta_t * g, eta_t)


# The lazy per-step worker operations: the ops wrappers (kernels on the
# card, plain versions on the CPU) or, with use_kernels=False, the plain
# versions on any device.  All update the worker's block in place.  (The
# catch-up of all workers is one ops.lazy_step_catchup launch on the
# kernel path; the plain path runs lazy_catchup_plain worker by worker.)


def _sim_lazy_touch(w_block, idx, val, coef, z_block, eta_m, lams, use_kernels):
    lam, lam1, lam2 = lams
    if use_kernels:
        return ops.lazy_block_touch_update(
            w_block, idx, val, coef, z_block, eta_m, lam=lam, lam1=lam1, lam2=lam2
        )
    return lazy_update.lazy_touch_update_plain(
        w_block, idx, val, coef, z_block, eta_m, lam, lam1, lam2
    )


def _sim_lazy_flush(w_block, last_block, z_block, eta, total, stop, lams, use_kernels):
    lam, lam1, lam2 = lams
    if use_kernels:
        return ops.lazy_block_flush(
            w_block, last_block, z_block, eta, total, stop, lam=lam, lam1=lam1, lam2=lam2
        )
    return lazy_update.lazy_flush_plain(
        w_block, last_block, z_block, eta, total, stop, lam, lam1, lam2
    )


def _sim_lazy_proba(w_block, idx, val, coef, z_block, corr_block, eta_m, lams, use_kernels):
    lam, lam1, lam2 = lams
    if use_kernels:
        return ops.lazy_block_proba_update(
            w_block, idx, val, coef, z_block, corr_block, eta_m,
            lam=lam, lam1=lam1, lam2=lam2,
        )
    return lazy_update.lazy_proba_update_plain(
        w_block, idx, val, coef, z_block, corr_block, eta_m, lam, lam1, lam2
    )


def _with_default_abort(
    recovery: RecoveryPolicy | None, n: int, nnz: int, q: int
) -> RecoveryPolicy | None:
    if recovery is None or recovery.on_abort is not None:
        return recovery
    return dataclasses.replace(recovery, on_abort=_default_fd_abort(n, nnz, q))


def fdsvrg_worker_simulation(
    data: PaddedCSR | None,
    partition: FeaturePartition,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    backend: Collectives | None = None,
    *,
    use_kernels: bool = True,
    block_data: BlockCSR | None = None,
    init_w: torch.Tensor | np.ndarray | None = None,
    lazy_updates: str | None = None,
    recovery: RecoveryPolicy | None = None,
    checkpoint: CheckpointPolicy | None = None,
    device: torch.device | str | None = None,
) -> RunResult:
    """Object-level Algorithm 1: a list of per-worker states; every
    inner-loop cross-worker scalar passes through ``backend.all_reduce``
    (default a fresh ``SimBackend`` running the explicit Figure-5 message
    schedule), and the full-gradient tree is metered once per outer via
    ``meter_tree``.  Each worker holds only its block-local rows and its
    ``w^(l)``.  Deliberately step by step and slow: this is the executable
    spec that certifies FD == serial inside the port.

    ``lazy_updates`` ("exact" | "proba") runs the worker-local
    delayed-decay flow (catch up before the margin read, update only the
    touched features, flush each block at epoch end); the all-reduce
    schedule is untouched.  ``use_kernels`` and ``device`` default as in
    :func:`run_fdsvrg`.
    """
    _check_lazy(lazy_updates)
    device = resolve_device(device)
    q = partition.num_blocks
    backend = backend or SimBackend(q)
    if block_data is None:
        if data is None:
            raise ValueError("pass data or a prebuilt block_data")
        block_data = BlockCSR.from_padded(data, partition)
    elif block_data.partition.bounds != partition.bounds:
        raise ValueError("block_data was built for a different partition")
    block_data = block_data.to(device)
    _check_kernel_dtype(block_data.values[0].dtype, use_kernels)
    labels = block_data.labels
    block_dims = block_data.block_dims
    bounds = _bounds(block_dims)
    n = block_data.num_instances
    u = cfg.batch_size
    u_t = torch.full((), float(u), dtype=block_data.values[0].dtype, device=device)

    def split(w):
        return [w[bounds[l]:bounds[l + 1]] for l in range(q)]

    def snapshot(w):
        # Lines 3-4: per-worker partial margins, canonical tree-order sum;
        # line 5: each worker's purely local scatter of its full-gradient
        # block (on the card, one launch covers all q workers' blocks).
        if use_kernels:
            s0 = ops.snapshot_margins(block_data, w)
        else:
            blocks = split(w)
            s0 = tree_order_sum([local_margins(*block_data.block(l), blocks[l])
                                 for l in range(q)])
        coeffs0 = ops.snapshot_coef(block_data, s0, loss) if use_kernels else \
            logistic_grad.snapshot_coef_plain(s0, labels, n, loss.dvalue)
        return _snapshot_scatter(block_data, coeffs0, use_kernels), s0

    lams = _lazy_lams(reg)
    exact = lazy_updates == "exact"
    corr_blocks = (
        [ops.step_corrections(block_data.nnz_col_block(l), n, u) for l in range(q)]
        if lazy_updates == "proba"
        else None
    )

    def epoch(t, rng, w, z_data, s0, eta_scale=1.0):
        # Account the full-gradient tree this outer consumed (lines 3-4).
        backend.meter_tree(payload=n)
        eta_eff = cfg.eta * eta_scale
        w = w.clone()  # the lazy steps and the kernel path's updates work in place
        blocks = split(w)
        z_blocks = split(z_data)
        samples = draw_samples(rng, n, cfg.inner_steps, u)
        mask = option_mask(rng, cfg.inner_steps, cfg.option)
        eta_full = float(np.float32(eta_eff))
        stop = int(mask.sum())
        last = torch.zeros((block_data.dim,), dtype=torch.int32, device=device)
        lasts = split(last)
        ids_all = _to_device(samples.astype(np.int64), device)
        rows_buf = ops.step_rows(block_data, u) if use_kernels else None
        for m in range(cfg.inner_steps):
            ids = ids_all[m]
            # Replay each touched feature's deferred steps so the margin
            # read below sees the materialized values; lines 9-10: per-worker
            # partial margins, tree-summed (u scalars).
            if use_kernels:
                if exact:
                    ops.lazy_step_catchup(block_data, ids, w, last, z_data, eta_full, m,
                                          stop, lam=lams[0], lam1=lams[1], lam2=lams[2])
                step = ops.step_margins(block_data, ids, w, partials=True, out=rows_buf)
                rows, partial_m = step.rows, list(step.parts)
            else:
                rows = _gather_rows(block_data, ids)
                if exact:
                    for l in range(q):
                        lazy_update.lazy_catchup_plain(blocks[l], lasts[l], z_blocks[l],
                                                       rows[l][0], eta_full, m, stop, *lams)
                partial_m = [local_margins(*rows[l], blocks[l]) for l in range(q)]
            s_m = backend.all_reduce(partial_m, payload=u)
            coef = ops.step_coef(block_data, ids, s_m, s0, u_t, loss) if use_kernels else \
                logistic_grad.step_coef_plain(s_m, ids, labels, s0, u_t, loss.dvalue)
            eta_m = float(np.float32(eta_eff * float(mask[m])))
            # Line 11: purely local prox update on each block (the prox is
            # elementwise, paper eq. 3, so no worker needs its peers).
            for l in range(q):
                idx, val = rows[l]
                if lazy_updates is None:
                    blocks[l] = _sim_update(blocks[l], idx, val, coef, z_blocks[l], eta_m,
                                            reg, use_kernels)
                elif exact:
                    _sim_lazy_touch(blocks[l], idx, val, coef, z_blocks[l], eta_m, lams,
                                    use_kernels)
                else:
                    _sim_lazy_proba(blocks[l], idx, val, coef, z_blocks[l], corr_blocks[l],
                                    eta_m, lams, use_kernels)
        if exact:
            # Epoch-end reconciliation, worker-locally (zero communication).
            for l in range(q):
                _sim_lazy_flush(blocks[l], lasts[l], z_blocks[l], eta_full,
                                cfg.inner_steps, stop, lams, use_kernels)
        return torch.cat(blocks) if q > 1 else blocks[0]

    return run_outer_loop(
        outer_iters=cfg.outer_iters,
        seed=cfg.seed,
        init_w=resolve_init_w(init_w, block_data.dim, block_data.values[0].dtype, device),
        snapshot=snapshot,
        epoch=epoch,
        evaluate=make_same_iterate_eval(labels, loss, reg, cfg.eta),
        backend=backend,
        recovery=_with_default_abort(recovery, n, block_data.global_nnz_max(), q),
        checkpoint=checkpoint,
    )
