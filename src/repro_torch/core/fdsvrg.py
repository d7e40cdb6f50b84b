"""FD-SVRG (paper Algorithm 1) and serial SVRG (paper Algorithm 2).

Port of ``repro.core.fdsvrg`` for the main path:

* :func:`run_serial_svrg` — Algorithm 2 (Johnson & Zhang), options I/II,
  on the q = 1 block layout.
* :func:`run_fdsvrg` — Algorithm 1 at simulation level: margins are the
  tree-order sum of per-block partials, communication is metered with the
  paper's accounting through a ``Collectives`` backend.

Both are thin wrappers over :class:`repro_torch.optim.update_rules.SVRGRule`
running under :func:`repro_torch.core.driver.run_outer_loop`.  The two
hooks of the rule are here: :func:`_full_grad_blocks` (snapshot) and
:func:`_inner_epoch` (epoch; the reference's ``lax.scan`` becomes a Python
loop that never waits on the device).

``use_kernels=True`` (the default) routes the gather-margin and the fused
scatter + update + prox through :mod:`repro_torch.kernels.ops`: the CUDA
kernels on a CUDA device, their plain PyTorch versions on the CPU.
``use_kernels=False`` is the plain path written like the reference's
jnp oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import RecoveryPolicy, RunResult, resolve_device
from repro_torch.core.partition import FeaturePartition, balanced
from repro_torch.data.block_csr import BlockCSR, local_margins, local_scatter
from repro_torch.data.sparse import PaddedCSR, margins_rows, scatter_grad
from repro_torch.dist import COSTS, ClusterModel, Collectives, SimBackend, tree_order_sum
from repro_torch.dist.meter import tree_rounds
from repro_torch.kernels import ops


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


def _divide(x: torch.Tensor, n: int | float) -> torch.Tensor:
    """``x / n`` as a true float32 division on every device (a CUDA tensor
    divided by a Python scalar is multiplied by the reciprocal instead)."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


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
    coeffs = _divide(loss.dvalue(s0, data.labels), data.num_instances)
    return scatter_grad(data.indices, data.values, coeffs, w.shape[0]), s0


# ---------------------------------------------------------------------------
# Block-local hot paths
# ---------------------------------------------------------------------------


def _bounds(block_dims: tuple[int, ...]) -> tuple[int, ...]:
    b = [0]
    for d in block_dims:
        b.append(b[-1] + d)
    return tuple(b)


def _block_margins(idx, val, w_block, use_kernels: bool) -> torch.Tensor:
    """Per-block partial margins over block-LOCAL rows."""
    if use_kernels:
        return ops.sparse_margins(idx, val, w_block)
    return local_margins(idx, val, w_block)


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
    bounds = _bounds(bd.block_dims)
    parts = [
        _block_margins(
            bd.indices[l], bd.values[l], w[bounds[l]:bounds[l + 1]], use_kernels
        )
        for l in range(bd.num_blocks)
    ]
    s0 = tree_order_sum(parts)
    coeffs = _divide(loss.dvalue(s0, bd.labels), bd.num_instances)
    z_blocks = [
        local_scatter(bd.indices[l], bd.values[l], coeffs, bd.block_dims[l])
        for l in range(bd.num_blocks)
    ]
    z_data = torch.cat(z_blocks) if len(z_blocks) > 1 else z_blocks[0]
    return z_data, s0


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
    step makes the host wait for the device.
    """
    bd = block_data
    device = w0.device
    q = bd.num_blocks
    m_total, u = samples.shape
    bounds = _bounds(bd.block_dims)
    eta_steps = np.float32(eta) * step_mask.astype(np.float32)  # float32[M]
    ids_all = _to_device(samples.astype(np.int64), device)
    u_t = torch.full((), float(u), dtype=w0.dtype, device=device)
    if not use_kernels:
        eta_dev = _to_device(eta_steps, device)
    lams = (reg.smooth_lam, reg.prox_l1, reg.prox_l2)
    w_blocks = [w0[bounds[l]:bounds[l + 1]] for l in range(q)]
    z_blocks = [z_data[bounds[l]:bounds[l + 1]] for l in range(q)]
    for m in range(m_total):
        ids = ids_all[m]
        y = bd.labels[ids]
        rows = [(bd.indices[l][ids], bd.values[l][ids]) for l in range(q)]
        parts = [
            _block_margins(rows[l][0], rows[l][1], w_blocks[l], use_kernels)
            for l in range(q)
        ]
        # Pairwise summation mirroring Figure 5 (the FD == serial contract).
        s_m = tree_order_sum(parts)
        coef = (loss.dvalue(s_m, y) - loss.dvalue(s0[ids], y)) / u_t
        for l in range(q):
            idx, val = rows[l]
            if use_kernels:
                w_blocks[l] = ops.fused_block_prox_update(
                    w_blocks[l], idx, val, coef, z_blocks[l], float(eta_steps[m]),
                    lam=lams[0], lam1=lams[1], lam2=lams[2],
                )
            else:
                eta_m = eta_dev[m]
                g = local_scatter(idx, val, coef, bd.block_dims[l])
                g = g + z_blocks[l] + reg.smooth_grad(w_blocks[l])
                w_blocks[l] = reg.prox(w_blocks[l] - eta_m * g, eta_m)
    return torch.cat(w_blocks) if q > 1 else w_blocks[0]


def _check_lazy(lazy_updates: str | None) -> None:
    if lazy_updates is not None:
        raise NotImplementedError(
            f"lazy_updates={lazy_updates!r}: the delayed-decay inner epoch and "
            "its four kernels are not ported yet (ROADMAP queue 1, item 4 and "
            "queue 2, items 4-7)"
        )


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
    device: torch.device | str | None = None,
) -> RunResult:
    """Serial SVRG on the q = 1 layout.

    ``use_kernels`` defaults to ``True`` (the reference's default is
    ``False``): on a CUDA device the run goes through the CUDA kernels.
    ``device`` defaults to ``cuda`` and raises when no CUDA device exists;
    pass ``device="cpu"`` for the plain path on the CPU.
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
        SVRGRule(use_kernels=use_kernels),
        make_context(block_data.to(device), loss, reg, cfg),
        init_w=init_w,
        recovery=recovery,
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
    device exists.
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
        SVRGRule(use_kernels=use_kernels),
        make_context(block_data.to(device), loss, reg, cfg, backend=backend),
        init_w=init_w,
        recovery=recovery,
    )
