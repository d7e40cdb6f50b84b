"""Instance-distributed baselines the paper compares against (§3, §5, App. B).

Port of ``repro.core.baselines``:

* :func:`run_dsvrg` — DSVRG (Lee et al., 2017): decentralized ring; the
  full gradient is computed in parallel over instance shards, the inner
  loop runs on ONE machine at a time over its local shard.  Comm per
  outer: 2qd (full-gradient round) + 2d (parameter handoff).
* :func:`run_syn_svrg` — SynSVRG on a Parameter Server (App. B, Alg 3/4):
  synchronous mini-batch SVRG, one sample per worker per step; every step
  pulls the dense w and pushes gradients.
* :func:`run_asy_svrg` — AsySVRG on a Parameter Server (App. B, Alg 5/6):
  the same traffic per step, asynchronous: gradients are computed at
  stale parameters (bounded delay <= q - 1).
* :func:`run_pslite_sgd` — PS-Lite (SGD): asynchronous SGD, no variance
  reduction (the paper's Table 3 baseline).

Each runs on the q = 1 block layout of the data (its padded rows as they
are), built once a run, under the one outer-loop harness with the same
losses, regularizers and §4.5 closed forms (:data:`repro_torch.dist.COSTS`)
as FD-SVRG; the meters use the ``PaddedCSR``'s row width, as the
reference's do.  The snapshot is
:func:`~repro_torch.core.fdsvrg._full_grad_blocks` and DSVRG's and
SynSVRG's epoch :func:`~repro_torch.core.fdsvrg._inner_epoch` on that
layout.  The asynchronous pair's epoch is :func:`_async_epoch`.

``use_kernels=True`` (the default) routes every function the port has a
kernel for through :mod:`repro_torch.kernels.ops` (the CUDA kernels on a
CUDA device, their plain versions on the CPU): a snapshot's margins,
coefficients and scatter (one launch each), and a step's margins, its
coefficients (one ``logistic_grad`` launch; PS-Lite's ``dl(s, y)`` is the
PyTorch chain) and its scatter + update + prox (one ``prox_update``
launch).  On the card every such run is bitwise reproducible.  The kernels
take float32 data; ``use_kernels=False`` is the plain path written like
the reference's jnp code and keeps the data's dtype.  ``device`` defaults
to ``cuda`` and raises when no CUDA device exists.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import (
    RunResult,
    draw_samples,
    make_same_iterate_eval,
    option_mask,
    resolve_device,
    resolve_init_w,
    run_outer_loop,
)
from repro_torch.core.fdsvrg import (
    SVRGConfig,
    _check_kernel_dtype,
    _full_grad_blocks,
    _inner_epoch,
    _to_device,
)
from repro_torch.core.partition import balanced
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.sparse import PaddedCSR
from repro_torch.dist import COSTS, ClusterModel, Collectives, SimBackend
from repro_torch.kernels import ops


def instance_shards(n: int, q: int) -> list[tuple[int, int]]:
    """The q contiguous instance shards ``[lo, hi)``, the first ``n mod q``
    one row longer."""
    base, rem = divmod(n, q)
    out, lo = [], 0
    for k in range(q):
        hi = lo + base + (1 if k < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _layout(data: PaddedCSR, use_kernels: bool, device: torch.device) -> BlockCSR:
    """The q = 1 layout of ``data`` on ``device``."""
    _check_kernel_dtype(data.values.dtype, use_kernels)
    return BlockCSR.from_padded(data, balanced(data.dim, 1)).to(device)


def _run(
    bd: BlockCSR,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    backend: Collectives,
    epoch: Callable,
    init_w,
    use_kernels: bool,
) -> RunResult:
    def snapshot(w):
        return _full_grad_blocks(bd, w, loss, use_kernels)

    return run_outer_loop(
        outer_iters=cfg.outer_iters,
        seed=cfg.seed,
        init_w=resolve_init_w(init_w, bd.dim, bd.values[0].dtype, bd.device),
        snapshot=snapshot,
        epoch=epoch,
        evaluate=make_same_iterate_eval(bd.labels, loss, reg, cfg.eta),
        backend=backend,
    )


# ---------------------------------------------------------------------------
# DSVRG
# ---------------------------------------------------------------------------


def run_dsvrg(
    data: PaddedCSR,
    q: int,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    cluster: ClusterModel | None = None,
    backend: Collectives | None = None,
    *,
    init_w: torch.Tensor | np.ndarray | None = None,
    use_kernels: bool = True,
    device: torch.device | str | None = None,
) -> RunResult:
    """DSVRG: the inner loop of outer t runs on machine ``t mod q``, sampling
    its own instance shard (paper: M = N/q local steps)."""
    device = resolve_device(device)
    backend = backend or SimBackend(q, cluster)
    n, d, nnz = data.num_instances, data.dim, data.nnz_max
    bd = _layout(data, use_kernels, device)
    shards = instance_shards(n, q)
    m_local, u = cfg.inner_steps, cfg.batch_size

    def epoch(t, rng, w, z_data, s0):
        # center -> q machines: w (d each); machines -> center: grad (d each)
        fg = COSTS.dsvrg_fullgrad(n=n, d=d, nnz=nnz, q=q)
        backend.p2p(fg.scalars, "dsvrg_fullgrad", rounds=fg.rounds)
        backend.charge_cost(fg)
        lo, hi = shards[t % q]
        samples = rng.integers(lo, hi, size=(m_local, u)).astype(np.int32)
        mask = option_mask(rng, m_local, cfg.option)
        w = _inner_epoch(bd, w, z_data, s0, samples, cfg.eta, mask, loss, reg, use_kernels)
        # M serial steps + center -> J: full gradient (d); J -> center:
        # parameter (d)
        ep = COSTS.dsvrg_epoch(m=m_local, nnz=nnz, d=d, u=u)
        backend.p2p(ep.scalars, "dsvrg_handoff", rounds=ep.rounds)
        backend.charge_cost(ep)
        return w

    return _run(bd, loss, reg, cfg, backend, epoch, init_w, use_kernels)


# ---------------------------------------------------------------------------
# SynSVRG (Parameter Server, Appendix B Algorithms 3-4)
# ---------------------------------------------------------------------------


def run_syn_svrg(
    data: PaddedCSR,
    q: int,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    cluster: ClusterModel | None = None,
    backend: Collectives | None = None,
    *,
    init_w: torch.Tensor | np.ndarray | None = None,
    use_kernels: bool = True,
    device: torch.device | str | None = None,
) -> RunResult:
    """SynSVRG: each synchronous step takes one sample per worker, a
    mini-batch of q."""
    device = resolve_device(device)
    backend = backend or SimBackend(q, cluster)
    n, d, nnz = data.num_instances, data.dim, data.nnz_max
    bd = _layout(data, use_kernels, device)

    def epoch(t, rng, w, z_data, s0):
        fg = COSTS.ps_fullgrad(n=n, d=d, nnz=nnz, q=q)
        backend.p2p(fg.scalars, "ps_fullgrad", rounds=fg.rounds)
        backend.charge_cost(fg)
        samples = draw_samples(rng, n, cfg.inner_steps, q)
        mask = option_mask(rng, cfg.inner_steps, cfg.option)
        w = _inner_epoch(bd, w, z_data, s0, samples, cfg.eta, mask, loss, reg, use_kernels)
        # per step: q workers pull dense w (q*d), push sparse VR grads
        # (2*u*nnz keys+values each) -- the <key,value> concession.
        st = COSTS.syn_inner_step(d=d, nnz=nnz, q=q, u=cfg.batch_size)
        backend.p2p(st.scalars * cfg.inner_steps, "ps_inner",
                    rounds=st.rounds * cfg.inner_steps)
        backend.charge_cost(st, steps=cfg.inner_steps)
        return w

    return _run(bd, loss, reg, cfg, backend, epoch, init_w, use_kernels)


# ---------------------------------------------------------------------------
# Asynchronous inner loops (AsySVRG and PS-Lite SGD share the machinery)
# ---------------------------------------------------------------------------


def _async_epoch(
    bd: BlockCSR,  # the q = 1 layout
    w0: torch.Tensor,
    z_data: torch.Tensor,  # the snapshot's z (VR) or zeros
    s0: torch.Tensor | None,  # the snapshot's margins (VR only)
    samples: np.ndarray,  # int32[M]
    delays: np.ndarray,  # int32[M] in [0, delay_buf)
    eta: float,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    delay_buf: int,
    variance_reduced: bool,
    use_kernels: bool,
) -> torch.Tensor:
    """Asynchronous PS inner loop with a bounded-staleness ring buffer.

    Step m computes its gradient at the iterate that was current
    ``delays[m]`` server updates ago (Alg 5/6: workers pull, compute, push
    while the server keeps moving); the server applies the proximal update
    to its fresh iterate, with the smooth part of g taken at the stale
    pull:

        w_next = prox(w_now - eta * ((coef * x + z) + grad g_smooth(w_stale)))

    with ``coef = dl(s_m) - dl(s0_i)`` (VR, z the snapshot's) or
    ``dl(s_m)`` (z = 0).  The ring's slots are host ints from ``delays``,
    so no step waits on the device.  The kernel path keeps the ring as
    ``delay_buf`` rows of one device tensor and writes each step's iterate
    into its slot with one ``prox_update`` launch, after folding ``z +
    grad g_smooth(w_stale)`` into one dense vector and scaling each value
    before the scatter: it reassociates the reference's sum, and adds each
    id's terms in flat order, so it is deterministic on the card.  The
    plain path is the reference's step op for op.
    """
    device, dtype = w0.device, w0.dtype
    m_total = samples.shape[0]
    ids_all = _to_device(samples.astype(np.int64), device)
    lam = reg.smooth_lam
    if not use_kernels:
        eta_t = torch.full((), float(np.float32(eta)), dtype=dtype, device=device)
        ring = [w0] * delay_buf
        for m in range(m_total):
            i = int(samples[m])
            w_now, w_stale = ring[m % delay_buf], ring[(m - int(delays[m])) % delay_buf]
            idx, val, y = bd.indices[0][i], bd.values[0][i], bd.labels[i]
            s_m = torch.sum(w_stale[idx] * val)
            x = torch.zeros_like(w0).index_add_(0, idx, val)
            if variance_reduced:
                g = (loss.dvalue(s_m, y) - loss.dvalue(s0[i], y)) * x + z_data
            else:
                g = loss.dvalue(s_m, y) * x
            g = g + reg.smooth_grad(w_stale)
            ring[(m + 1) % delay_buf] = reg.prox(w_now - eta_t * g, eta_t)
        return ring[m_total % delay_buf]
    ring = w0.expand(delay_buf, -1).clone()
    rows = ops.step_rows(bd, 1)
    one = torch.ones((), dtype=dtype, device=device)
    z_step = torch.empty_like(w0) if lam else z_data
    y_all = None if variance_reduced else bd.labels[ids_all]
    for m in range(m_total):
        stale = ring[(m - int(delays[m])) % delay_buf]
        ids = ids_all[m:m + 1]
        s_m, ((idx, val),), _ = ops.step_margins(bd, ids, stale, out=rows)
        if variance_reduced:
            coef = ops.step_coef(bd, ids, s_m, s0, one, loss)
        else:
            coef = loss.dvalue(s_m, y_all[m:m + 1])
        if lam:
            torch.add(z_data, stale, alpha=lam, out=z_step)
        ops.fused_block_prox_update(
            ring[m % delay_buf], idx, val, coef, z_step, eta,
            lam=0.0, lam1=reg.prox_l1, lam2=reg.prox_l2, out=ring[(m + 1) % delay_buf],
        )
    return ring[m_total % delay_buf].clone()


def _run_async(
    data: PaddedCSR,
    q: int,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    backend: Collectives,
    variance_reduced: bool,
    kind: str,
    init_w,
    use_kernels: bool,
    device: torch.device | str | None,
) -> RunResult:
    device = resolve_device(device)
    n, d, nnz = data.num_instances, data.dim, data.nnz_max
    delay_buf = max(2, q)
    bd = _layout(data, use_kernels, device)

    def epoch(t, rng, w, z_data, s0):
        # The snapshot is the VR anchor; for PS-Lite it is reporting-only
        # and the epoch takes z = 0 (in the data's dtype) and no s0.
        if variance_reduced:
            fg = COSTS.ps_fullgrad(n=n, d=d, nnz=nnz, q=q)
            backend.p2p(fg.scalars, f"{kind}_fullgrad", rounds=fg.rounds)
            backend.charge_cost(fg)
        else:
            z_data, s0 = torch.zeros_like(w), None
        samples = rng.integers(0, n, size=cfg.inner_steps).astype(np.int32)
        delays = rng.integers(0, q, size=cfg.inner_steps).astype(np.int32)
        w = _async_epoch(bd, w, z_data, s0, samples, delays, cfg.eta, loss, reg, delay_buf,
                         variance_reduced, use_kernels)
        # per async step: one worker pulls dense w (d) and pushes a sparse
        # (VR-)gradient (2*nnz); the server serializes message handling.
        per_step = COSTS.async_step_scalars(d=d, nnz=nnz)
        backend.p2p(per_step * cfg.inner_steps, f"{kind}_inner", rounds=2 * cfg.inner_steps)
        backend.charge_seconds(
            cfg.inner_steps * COSTS.async_step_seconds(backend.cluster, d=d, nnz=nnz, q=q)
        )
        return w

    return _run(bd, loss, reg, cfg, backend, epoch, init_w, use_kernels)


def run_asy_svrg(
    data: PaddedCSR,
    q: int,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    cluster: ClusterModel | None = None,
    backend: Collectives | None = None,
    *,
    init_w: torch.Tensor | np.ndarray | None = None,
    use_kernels: bool = True,
    device: torch.device | str | None = None,
) -> RunResult:
    """AsySVRG: variance-reduced asynchronous steps, staleness < q."""
    return _run_async(data, q, loss, reg, cfg, backend or SimBackend(q, cluster),
                      True, "asysvrg", init_w, use_kernels, device)


def run_pslite_sgd(
    data: PaddedCSR,
    q: int,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    cfg: SVRGConfig,
    cluster: ClusterModel | None = None,
    backend: Collectives | None = None,
    *,
    init_w: torch.Tensor | np.ndarray | None = None,
    use_kernels: bool = True,
    device: torch.device | str | None = None,
) -> RunResult:
    """PS-Lite SGD: asynchronous steps without variance reduction."""
    return _run_async(data, q, loss, reg, cfg, backend or SimBackend(q, cluster),
                      False, "pslite", init_w, use_kernels, device)


__all__ = [
    "instance_shards",
    "run_asy_svrg",
    "run_dsvrg",
    "run_pslite_sgd",
    "run_syn_svrg",
]
