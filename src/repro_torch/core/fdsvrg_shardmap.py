"""Deployable FD-SVRG: one rank per feature block over ``torch.distributed``.

Port of ``repro.core.fdsvrg_shardmap``.  Every rank is one of the paper's
Workers: it holds only its own feature block — block l of
``BlockCSR.from_padded(data, balanced(dim, q))`` as a one-block layout
(:meth:`~repro_torch.data.block_csr.BlockCSR.block_of`, built without the
other blocks: local ids, the block's own width ``nnz_l``, every label) — and its slice ``w^(l)`` of the
iterate.  Where the reference maps one worker function over a JAX mesh
with ``shard_map``, each rank here runs the same worker code on its own
block (SPMD; :func:`repro_torch.dist.launch.spawn_ranks` starts the ranks).

Communication per inner step is exactly one all-reduce of ``u`` scalars
(:meth:`~repro_torch.dist.shardmap.ShardMapBackend.device_all_reduce`);
the snapshot all-reduces the N-vector of margins once per outer.
Everything else is rank-local.  The backend's ``tree_mode`` selects the
collective:

  * ``"psum"``      — one all-reduce (the backend's own algorithm)
  * ``"butterfly"`` — the recursive-doubling butterfly of paired sends and
    receives, bit for bit ``tree_order_sum`` of the q partials for a
    power-of-two q, so a butterfly run equals :func:`~repro_torch.core.fdsvrg.run_fdsvrg`
    at the same q and seed bit for bit.

``use_kernels=True`` (the default) routes a rank's work through
:mod:`repro_torch.kernels.ops` on its one block: the snapshot's margins
(kernel 1), coefficients (kernel 9) and scatter (the port's
``block_scatter``); a step's margins with its gathered rows (kernel 1),
coefficients (kernel 9) and the fused scatter + update + prox (kernel 2),
in place — the launches and the bytes :func:`run_fdsvrg` gives block l.
``False`` is the plain path written like the reference's jnp worker.

Builders (:func:`make_fullgrad`, :func:`make_inner_epoch`,
:func:`make_outer_iteration`) return the rank's halves of an outer
iteration; a rank's rows and labels travel together as its one-block
``BlockCSR``.  :func:`run_fdsvrg_sharded` plugs the two halves into the
shared outer-loop harness, so every rank reports the same
:class:`~repro_torch.core.driver.RunResult` — objectives and residuals at
the gathered iterate, as :func:`run_fdsvrg` computes them — and meters
host-side with the shared §4.5 closed forms (:data:`repro_torch.dist.COSTS`).

Unlike the reference, ``dim`` need not divide by q: blocks are
``balanced``, as :func:`run_fdsvrg`'s are.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import (
    RunResult,
    draw_samples,
    make_same_iterate_eval,
    resolve_device,
    resolve_init_w,
    run_outer_loop,
)
from repro_torch.core.fdsvrg import _check_kernel_dtype, _to_device
from repro_torch.core.partition import balanced
from repro_torch.data.block_csr import BlockCSR, local_margins, local_scatter
from repro_torch.dist import COSTS, ClusterModel, ShardMapBackend
from repro_torch.kernels import logistic_grad, ops


def _opt_residual_blk(reg, eta, w_blk, z_blk):
    """Block-local optimality residual: the gradient for smooth g, the
    prox gradient mapping otherwise (the per-block body of
    ``repro_torch.core.driver.optimality_norm``; callers sum the squares
    over the ranks).  Only the fused step reports it — the harness driver
    evaluates at the gathered iterate like everyone else."""
    if reg.is_smooth:
        return z_blk + reg.grad(w_blk)
    v_blk = reg.prox(w_blk - eta * (z_blk + reg.smooth_grad(w_blk)), eta)
    return (w_blk - v_blk) / eta


@dataclasses.dataclass(frozen=True)
class FDSVRGShardedConfig:
    dim: int
    num_instances: int
    nnz_max: int  # nnz budget of the GLOBAL rows (metering uses this)
    eta: float
    inner_steps: int
    batch_size: int = 16
    loss_name: str = "logistic"
    reg_name: str = "l2"  # "l2" | "l1" | "elastic_net" | "none"
    lam: float = 1e-4
    lam2: float = 0.0  # elastic-net L2 strength
    tree_mode: str = "psum"  # or "butterfly"
    use_kernels: bool = True


def _resolve_backend(
    mesh,
    cfg: FDSVRGShardedConfig,
    feature_axes: Sequence[str],
    backend: ShardMapBackend | None,
    cluster: ClusterModel | None = None,
) -> ShardMapBackend:
    """Shared builder plumbing: backend/mesh consistency.  ``mesh=None``
    is one rank with no process group."""
    if backend is None:
        if mesh is None:
            return ShardMapBackend(q=1, tree_mode=cfg.tree_mode, cluster=cluster)
        return ShardMapBackend(mesh=mesh, feature_axes=feature_axes, tree_mode=cfg.tree_mode,
                               cluster=cluster)
    if backend.mesh is not mesh or (
        mesh is not None and backend.feature_axes != tuple(feature_axes)
    ):
        raise ValueError(
            "backend was built on a different mesh/feature_axes than the ones "
            "passed to the step builder"
        )
    if mesh is None and backend.q != 1:
        raise ValueError(
            f"without a mesh the run has one rank, but the backend has q={backend.q}"
        )
    return backend


def _margin_of(cfg: FDSVRGShardedConfig, block: BlockCSR, w_blk, ids=None, out=None):
    """The rank's partial margins and, for a step, its gathered rows: on the
    kernel path one launch of kernel 1 (the step's rows written into
    ``out``), else the torch gathers and ``local_margins``."""
    if ids is None:
        if cfg.use_kernels:
            return ops.snapshot_margins(block, w_blk), None
        return local_margins(block.indices[0], block.values[0], w_blk), None
    if cfg.use_kernels:
        s, rows, _ = ops.step_margins(block, ids, w_blk, out=out)
        return s, rows[0]
    rows = (block.indices[0][ids], block.values[0][ids])
    return local_margins(*rows, w_blk), rows


def _fullgrad_blk(cfg, backend, loss, block, w_blk):
    """Full-gradient phase on one rank (Alg 1 lines 3-5): one N-vector
    all-reduce, then a purely block-local scatter."""
    partial, _ = _margin_of(cfg, block, w_blk)
    s0 = backend.device_all_reduce(partial)
    if cfg.use_kernels:
        coeffs = ops.snapshot_coef(block, s0, loss)
        return ops.snapshot_scatter(block, coeffs), s0
    coeffs = logistic_grad.snapshot_coef_plain(s0, block.labels, block.num_instances,
                                               loss.dvalue)
    return local_scatter(block.indices[0], block.values[0], coeffs, block.dim), s0


def _inner_scan_blk(cfg, backend, loss, reg, block, w_blk, z_blk, s0, samples):
    """M inner steps on one rank: one u-scalar all-reduce per step; the prox
    is elementwise on the local block, so the traffic is the same for
    every regularizer.  The sample ids go to the device once an epoch; the
    kernel path updates a copy of ``w_blk`` in place."""
    m_total, u = samples.shape
    device, dtype = w_blk.device, w_blk.dtype
    eta32 = float(np.float32(cfg.eta))
    ids_all = _to_device(samples.astype(np.int64), device)
    u_t = torch.full((), float(u), dtype=dtype, device=device)
    if cfg.use_kernels:
        w = w_blk.clone()
        rows_buf = ops.step_rows(block, u)
    else:
        w = w_blk
        rows_buf = None
        eta_t = torch.full((), eta32, dtype=torch.float32, device=device)
    for m in range(m_total):
        ids = ids_all[m]
        partial, (idx, val) = _margin_of(cfg, block, w, ids, rows_buf)
        s_m = backend.device_all_reduce(partial)
        if cfg.use_kernels:
            coef = ops.step_coef(block, ids, s_m, s0, u_t, loss)
            ops.fused_block_prox_update(w, idx, val, coef, z_blk, eta32, lam=reg.smooth_lam,
                                        lam1=reg.prox_l1, lam2=reg.prox_l2, out=w)
        else:
            coef = logistic_grad.step_coef_plain(s_m, ids, block.labels, s0, u_t, loss.dvalue)
            g = local_scatter(idx, val, coef, block.dim) + z_blk + reg.smooth_grad(w)
            w = reg.prox(w - eta_t * g, eta_t)
    return w


def _loss_reg(cfg: FDSVRGShardedConfig):
    return (losses_lib.LOSSES[cfg.loss_name],
            losses_lib.Regularizer(cfg.reg_name, cfg.lam, cfg.lam2))


def make_fullgrad(
    mesh,
    cfg: FDSVRGShardedConfig,
    feature_axes: Sequence[str] = ("data", "model"),
    backend: ShardMapBackend | None = None,
):
    """Build the rank's snapshot half: ``(w_blk, block) -> (z_blk, s0)``,
    ``z_blk`` the rank's block like ``w_blk``, ``s0`` (the margins at w)
    replicated.  This is the harness ``snapshot`` hook — its output
    rotates into the next epoch AND carries the same-iterate reporting
    pair."""
    backend = _resolve_backend(mesh, cfg, feature_axes, backend)
    loss, _ = _loss_reg(cfg)

    def fullgrad(w_blk, block):
        return _fullgrad_blk(cfg, backend, loss, block, w_blk)

    return fullgrad


def make_inner_epoch(
    mesh,
    cfg: FDSVRGShardedConfig,
    feature_axes: Sequence[str] = ("data", "model"),
    backend: ShardMapBackend | None = None,
):
    """Build the rank's epoch half: ``(w_blk, z_blk, s0, block, samples)
    -> w_blk_next``, the M-step inner loop consuming a snapshot from
    :func:`make_fullgrad` (``samples`` int32[M, u] on the host, the same
    on every rank)."""
    backend = _resolve_backend(mesh, cfg, feature_axes, backend)
    loss, reg = _loss_reg(cfg)

    def inner_epoch(w_blk, z_blk, s0, block, samples):
        return _inner_scan_blk(cfg, backend, loss, reg, block, w_blk, z_blk, s0,
                               np.asarray(samples))

    return inner_epoch


def make_outer_iteration(
    mesh,
    cfg: FDSVRGShardedConfig,
    feature_axes: Sequence[str] = ("data", "model"),
    backend: ShardMapBackend | None = None,
):
    """Build the fused one-outer-iteration function of a rank:
    ``(w_blk, block, samples) -> (w_blk_next, full_grad_norm)``.

    ``full_grad_norm`` is the optimality residual at the *snapshot*
    iterate (the full-gradient phase computes it for free; the squares
    are summed over the ranks by the backend's collective); the harness
    driver (:func:`run_fdsvrg_sharded`) reports post-epoch residuals
    instead.  Build a rank's block once with
    ``BlockCSR.block_of(data, balanced(dim, q), rank)``.
    """
    backend = _resolve_backend(mesh, cfg, feature_axes, backend)
    loss, reg = _loss_reg(cfg)

    def outer_iteration(w_blk, block, samples):
        z_blk, s0 = _fullgrad_blk(cfg, backend, loss, block, w_blk)
        sq = torch.sum(_opt_residual_blk(reg, cfg.eta, w_blk, z_blk) ** 2).reshape(1)
        gnorm_sq = backend.device_all_reduce(sq)
        w_next = _inner_scan_blk(cfg, backend, loss, reg, block, w_blk, z_blk, s0,
                                 np.asarray(samples))
        return w_next, torch.sqrt(gnorm_sq[0])

    return outer_iteration


def run_fdsvrg_sharded(
    data,
    mesh,
    cfg: FDSVRGShardedConfig,
    feature_axes: Sequence[str] = ("data", "model"),
    outer_iters: int = 1,
    seed: int = 0,
    cluster: ClusterModel | None = None,
    backend: ShardMapBackend | None = None,
    init_w: torch.Tensor | np.ndarray | None = None,
    *,
    block: BlockCSR | None = None,
    device: torch.device | str | None = None,
) -> RunResult:
    """Metered driver for the deployable path, on the shared harness; every
    rank of ``mesh`` calls it (``mesh=None``: one rank, no process group).

    The rank takes its block of ``data`` (a PaddedCSR) in the
    ``balanced(dim, q)`` partition, or the prebuilt one-block layout
    ``block`` (then ``data`` may be ``None``), and runs ``outer_iters``
    iterations of the split :func:`make_fullgrad` / :func:`make_inner_epoch`
    pair through :func:`repro_torch.core.driver.run_outer_loop` — so
    snapshot rotation, sample drawing (the same rng stream as
    :func:`repro_torch.core.fdsvrg.run_fdsvrg` at the same seed) and
    same-iterate objective/optimality reporting are the engine's.  The
    reports come from ``w`` and ``z`` gathered in block order on every
    rank.  Traffic and modeled time are charged from the shared closed
    forms, so the meter equals the simulation driver's for the same shapes.

    Returns a :class:`~repro_torch.core.driver.RunResult` whose ``w`` is
    the gathered iterate, the same on every rank.  ``device`` defaults to
    ``cuda`` (raising without a card) and ``cfg.use_kernels`` to ``True``,
    as everywhere in the port.
    """
    device = resolve_device(device)
    backend = _resolve_backend(mesh, cfg, feature_axes, backend, cluster)
    q = backend.q
    rank = 0 if mesh is None else backend.device_worker_id()
    part = balanced(cfg.dim, q)
    lo, hi = part.block(rank)
    if block is None:
        if data is None:
            raise ValueError("pass data or a prebuilt one-block layout (block=)")
        block = BlockCSR.block_of(data, part, rank)
    elif block.num_blocks != 1 or block.dim != hi - lo:
        raise ValueError(
            f"rank {rank} holds features [{lo}, {hi}) of the balanced({cfg.dim}, {q}) "
            f"partition; block= has {block.num_blocks} block(s) over {block.dim} features"
        )
    if block.num_instances != cfg.num_instances:
        raise ValueError(f"block= has {block.num_instances} rows, cfg.num_instances "
                         f"is {cfg.num_instances}")
    block = block.to(device)
    dtype = block.values[0].dtype
    _check_kernel_dtype(dtype, cfg.use_kernels)
    fullgrad = make_fullgrad(mesh, cfg, feature_axes, backend=backend)
    inner_epoch = make_inner_epoch(mesh, cfg, feature_axes, backend=backend)
    loss, reg = _loss_reg(cfg)
    n, nnz, u = cfg.num_instances, cfg.nnz_max, cfg.batch_size
    sizes = part.block_sizes()
    evaluate_full = make_same_iterate_eval(block.labels, loss, reg, cfg.eta)

    def snapshot(w_blk):
        return fullgrad(w_blk, block)

    def epoch(t, rng, w_blk, z_blk, s0):
        backend.meter_tree(payload=n)
        backend.charge_cost(COSTS.fd_fullgrad(n=n, nnz=nnz, q=q))
        samples = draw_samples(rng, n, cfg.inner_steps, u)
        w_blk = inner_epoch(w_blk, z_blk, s0, block, samples)
        backend.meter_tree(payload=u, steps=cfg.inner_steps)
        backend.charge_cost(COSTS.fd_inner_step(nnz=nnz, q=q, u=u), steps=cfg.inner_steps)
        return w_blk

    def evaluate(w_blk, z_blk, s0):
        return evaluate_full(backend.device_all_gather(w_blk, sizes),
                             backend.device_all_gather(z_blk, sizes), s0)

    w0 = resolve_init_w(init_w, cfg.dim, dtype, device)[lo:hi].clone()
    res = run_outer_loop(
        outer_iters=outer_iters,
        seed=seed,
        init_w=w0,
        snapshot=snapshot,
        epoch=epoch,
        evaluate=evaluate,
        backend=backend,
    )
    return dataclasses.replace(res, w=backend.device_all_gather(res.w, sizes))


def input_shardings(mesh=None, feature_axes: Sequence[str] = ("data", "model")):
    """The ``torch.distributed.tensor`` placements of
    :func:`make_outer_iteration`'s global inputs, one per mesh dimension:
    ``w`` and the ``[q, N, B]`` row stacks (:meth:`BlockCSR.stacked`)
    sharded on their leading axis, the labels and the samples
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    ndim = 1 if mesh is None else mesh.ndim
    shard, rep = (Shard(0),) * ndim, (Replicate(),) * ndim
    return (shard, shard, shard, rep, rep)
