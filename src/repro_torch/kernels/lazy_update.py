"""lazy_update: the delayed-decay (lazy) inner step, four kernels.

The dense inner step (:mod:`repro_torch.kernels.prox_update`) moves every
feature of a block at every step.  These move only the ``u * nnz_l``
features of the sampled rows and defer the decay of the rest:

* **exact** — a per-feature counter ``last`` (inner steps already applied):

  - :func:`lazy_catchup`: before step ``m`` reads its margins, each
    touched feature replays its deferred steps ``last[j] .. m-1`` — the
    dense step with g = +0.0 — as ``k_active = max(min(stop, m) - last[j],
    0)`` active steps plus at most one masked (eta = 0) step (the Option II
    mask is a prefix of ones, and a masked step is idempotent after one),
    then stamps ``last[j] = m + 1``; :func:`catchup` is one launch for a
    step's rows in all q blocks (:func:`catchup_plain` its plain version),
    :func:`lazy_catchup` the one-block case;
  - :func:`lazy_touch_update`: the dense prox step at the touched features
    only, each feature's contributions added in flat order from 0.0
    (first-occurrence accumulation, the dense scatter's order);
    :func:`touch_update` is one launch for a step's gathered rows in all q
    blocks, :func:`lazy_touch_update` the one-block case;
  - :func:`lazy_flush`: at epoch end every feature replays its remaining
    deferred steps, so the block equals the dense iterate; a feature's
    replay reads only its own state, so one launch over the q blocks' w,
    last and z concatenated is the q one-block flushes, bit for bit.

  Replay, not a closed form: ``(1 - eta*lam)**k * w`` rounds otherwise
  than k explicit steps, and the port's contract is that the exact lazy
  epoch equals the dense epoch bit for bit.

* **probabilistic** — :func:`lazy_proba_update`: only touched features
  move, the decay and both prox strengths scaled by ``corr[j] = 1 / P(j
  touched per step)`` (:func:`step_corrections`).  No counter, no flush,
  no bit promise.

The CUDA kernels (``csrc/lazy_update.cu``) replace the Pallas TPU kernels
of ``repro/kernels/lazy_update.py``.  **They update ``w`` (and ``last``)
in place** — the step stays O(u * nnz_l) with no copy of the block — and
so do the plain PyTorch versions beside them (the CPU path and the
card-side yardstick), which are the reference expressions of
``repro/kernels/ref.py``.  Operand conventions as in the reference:
``eta`` is the UNMASKED step in catch-up and flush and the MASKED one
(eta * mask[m]) in touch and proba; ``m``, ``stop`` and ``total`` are
ints; ``last`` is int32; ``eta``, ``lam``, ``lam1``, ``lam2`` are runtime
floats.  ``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prox_update import prox_plain

launches = {
    "lazy_catchup": 0,
    "lazy_touch_update": 0,
    "lazy_flush": 0,
    "lazy_proba_update": 0,
}


def step_corrections(
    nnz_col: torch.Tensor,  # int32[d_block] rows storing a nonzero per feature
    n: int,  # total instances
    u: int = 1,  # mini-batch size
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:  # [d_block]
    """Per-feature corrections ``1 / P(touched per step)``.

    A feature stored by ``nnz_col[j]`` of the n rows is touched by a
    uniform u-row mini-batch with probability ``1 - (1 - nnz_col/n)^u``.
    Features stored by no row are never touched; their correction is
    pinned to 1.0.  Plain PyTorch (the reference's is plain jnp)."""
    p1 = nnz_col.to(dtype) / torch.full((), float(n), dtype=dtype, device=nnz_col.device)
    p = 1.0 - (1.0 - p1) ** u
    safe = torch.where(nnz_col > 0, p, torch.ones_like(p))
    return torch.ones_like(safe) / safe


# ---------------------------------------------------------------------------
# The plain versions (ref.py:117-270), in place
# ---------------------------------------------------------------------------


def _lazy_step(w, z, eta: float, lam: float, lam1: float, lam2: float):
    """One dense step at untouched features (g = +0.0), in the dense
    step's association order."""
    g = 0.0 + z  # the scatter's +0.0 base; never -0.0
    g = g + lam * w
    return prox_plain(w - eta * g, eta, lam1, lam2)


def lazy_replay_plain(
    w: torch.Tensor,  # [L] gathered (or whole-block) weights
    z: torch.Tensor,  # [L]
    eta: float,  # UNMASKED step size
    k_active: torch.Tensor,  # int[L] active steps to replay
    has_masked: torch.Tensor,  # bool[L] replay one masked step too
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """``k_active`` untouched active steps, then at most one masked step.
    (Reads ``max(k_active)`` as a host int: on a CUDA tensor it waits for
    the card.)"""
    steps = int(k_active.max()) if k_active.numel() else 0
    for i in range(steps):
        w = torch.where(i < k_active, _lazy_step(w, z, eta, lam, lam1, lam2), w)
    masked = _lazy_step(w, z, eta * 0.0, lam, lam1, lam2)
    return torch.where(has_masked, masked, w)


def first_occurrence(flat: torch.Tensor) -> torch.Tensor:
    """first[e] = the smallest lane holding the same id as lane e.  Adding
    contributions at first-occurrence lanes in flat order is the dense
    scatter's per-feature order.  O(L^2), L = u * nnz_l."""
    return torch.argmax((flat[:, None] == flat[None, :]).to(torch.int32), dim=1)


def lazy_catchup_plain(
    w: torch.Tensor,  # [d_block], updated in place
    last: torch.Tensor,  # int32[d_block], updated in place
    z: torch.Tensor,
    indices: torch.Tensor,  # int32[u, nnz_l], ids touched at step m
    eta: float,  # UNMASKED step size
    m: int,
    stop: int,
    lam: float,
    lam1: float,
    lam2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay the deferred steps of every feature touched at step ``m`` and
    stamp ``last = m + 1`` (duplicate lanes compute the same value from
    the same old ``w``/``last``, so the scatter-set is benign)."""
    flat = indices.reshape(-1).long()
    ll = last[flat]
    k_active = torch.clamp_min(min(stop, m) - ll, 0)
    has_masked = (m - ll) > k_active
    w[flat] = lazy_replay_plain(w[flat], z[flat], eta, k_active, has_masked, lam, lam1, lam2)
    last[flat] = m + 1
    return w, last


def catchup_plain(
    indices: Sequence[torch.Tensor],  # per block: int32[N, nnz_l], local ids
    bounds: Sequence[int],  # [q + 1]: block l holds the features [b_l, b_{l+1})
    ids: torch.Tensor,  # int64[u] the step's sampled rows
    w: torch.Tensor,  # [d], the q blocks' w concatenated; in place
    last: torch.Tensor,  # int32[d]; in place
    z: torch.Tensor,  # [d]
    eta: float,
    m: int,
    stop: int,
    lam: float,
    lam1: float,
    lam2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of q blocks: :func:`lazy_catchup_plain` of each
    block's sampled rows, block after block."""
    for l, idx in enumerate(indices):
        lo, hi = bounds[l], bounds[l + 1]
        lazy_catchup_plain(w[lo:hi], last[lo:hi], z[lo:hi], idx[ids], eta, m, stop,
                           lam, lam1, lam2)
    return w, last


def _touched_grad(indices, values, coef):
    """(flat ids, first-occurrence lanes, per-lane g summed in flat order)."""
    flat = indices.reshape(-1).long()
    contrib = (values * coef[:, None]).reshape(-1)
    first = first_occurrence(flat)
    return flat, first, torch.zeros_like(contrib).index_add_(0, first, contrib)


def lazy_touch_update_plain(
    w: torch.Tensor,  # [d_block], caught up at the touched ids; in place
    indices: torch.Tensor,  # int32[u, nnz_l]
    values: torch.Tensor,  # [u, nnz_l]
    coef: torch.Tensor,  # [u]
    z: torch.Tensor,
    eta: float,  # MASKED step size
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """The dense prox step evaluated at the touched ids only."""
    flat, first, g = _touched_grad(indices, values, coef)
    wl = w[flat]
    g = g + z[flat]
    g = g + lam * wl
    v = prox_plain(wl - eta * g, eta, lam1, lam2)
    w[flat] = v[first]
    return w


def lazy_flush_plain(
    w: torch.Tensor,  # [d_block], updated in place
    last: torch.Tensor,  # int32[d_block]
    z: torch.Tensor,
    eta: float,  # UNMASKED step size
    total: int,  # inner steps M of the epoch
    stop: int,  # active steps
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """Replay every feature's deferred steps up to ``total``."""
    k_active = torch.clamp_min(min(stop, total) - last, 0)
    has_masked = (total - last) > k_active
    return w.copy_(lazy_replay_plain(w, z, eta, k_active, has_masked, lam, lam1, lam2))


def lazy_proba_update_plain(
    w: torch.Tensor,  # [d_block], in place
    indices: torch.Tensor,
    values: torch.Tensor,
    coef: torch.Tensor,
    z: torch.Tensor,
    corr: torch.Tensor,  # [d_block] step corrections
    eta: float,  # MASKED step size
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """Touched features only, decay and prox strengths scaled by corr."""
    flat, first, g = _touched_grad(indices, values, coef)
    wl = w[flat]
    cl = corr[flat]
    v = wl - eta * (g + cl * (z[flat] + lam * wl))
    if lam1 != 0.0 or lam2 != 0.0:
        # (eta * lam1) * c and 1 + (eta * lam2) * c, rounded in float32.
        thr = float(np.float32(eta) * np.float32(lam1)) * cl
        v = torch.sign(v) * torch.clamp_min(torch.abs(v) - thr, 0.0)
        if lam2 != 0.0:
            v = v / (1.0 + float(np.float32(eta) * np.float32(lam2)) * cl)
    w[flat] = v[first]
    return w


# ---------------------------------------------------------------------------
# The CUDA launchers
# ---------------------------------------------------------------------------


def _cuda_device(kernel: str, w: torch.Tensor) -> torch.device:
    if not w.is_cuda:
        raise ValueError(f"{kernel}: the CUDA kernel needs CUDA tensors")
    return w.device


def _launch(kernel: str, entry: str, dev: torch.device, *args) -> None:
    """Call the C entry point on the current stream, check, count."""
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    _build.check(rc, kernel)
    launches[kernel] += 1


def catchup(
    rows: _build.BlockRows,  # the q blocks' rows (ids only), on w's device
    q: int,
    ids: torch.Tensor | None,  # int64[u] sampled rows, or None: rows 0..u-1
    u: int,
    w: torch.Tensor,  # float32[d], the q blocks' w concatenated; in place
    last: torch.Tensor,  # int32[d]; in place
    z: torch.Tensor,  # float32[d]
    eta: float,
    m: int,
    stop: int,
    lam: float,
    lam1: float,
    lam2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the catch-up kernel on the current stream, one launch for the
    q blocks; returns (w, last).  The row ids must lie in ``[0, N)`` and
    ``rows`` must come from live tensors (the kernel checks neither)."""
    dev = _cuda_device("lazy_catchup", w)
    _build.require_tensor("lazy_catchup", "w", w, torch.float32, dev, (None,))
    (d,) = w.shape
    _build.require_tensor("lazy_catchup", "last", last, torch.int32, dev, (d,))
    _build.require_tensor("lazy_catchup", "z", z, torch.float32, dev, (d,))
    if ids is not None:
        _build.require_tensor("lazy_catchup", "ids", ids, torch.int64, dev, (u,))
    _launch("lazy_catchup", "repro_lazy_catchup", dev,
            ctypes.addressof(rows), q, None if ids is None else ids.data_ptr(), u,
            w.data_ptr(), last.data_ptr(), z.data_ptr(), float(eta), int(m), int(stop),
            float(lam), float(lam1), float(lam2))
    return w, last


def lazy_catchup(
    w: torch.Tensor,  # float32[d_block], updated in place
    last: torch.Tensor,  # int32[d_block], updated in place
    z: torch.Tensor,  # float32[d_block]
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids
    eta: float,
    m: int,
    stop: int,
    lam: float,
    lam1: float,
    lam2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One block's catch-up through the kernel: the q = 1 case over the
    rows ``indices``; returns (w, last)."""
    dev = _cuda_device("lazy_catchup", w)
    rows = _build.block_rows("lazy_catchup", (indices,), None, w.shape, dev)
    return catchup(rows, 1, None, indices.shape[0], w, last, z, eta, m, stop, lam, lam1, lam2)


def touch_update(
    rows: _build.BlockRows,  # the q blocks' widths and offsets (nnz, lo, off)
    q: int,
    indices: torch.Tensor,  # int32[u * sum_l nnz_l]: the step's gathered ids, block-LOCAL
    values: torch.Tensor,  # float32[u * sum_l nnz_l]
    coef: torch.Tensor,  # float32[u]
    w: torch.Tensor,  # float32[d], the q blocks' w concatenated; in place
    z: torch.Tensor,  # float32[d]
    eta: float,
    lam: float,
    lam1: float,
    lam2: float,
    corr: torch.Tensor | None = None,  # float32[d]: the probabilistic update
) -> torch.Tensor:
    """Launch the touched pass on the current stream, one launch for the q
    blocks: the exact step, or with ``corr`` the probabilistic one.  Block
    l's u rows lie at ``u * off[l]`` of the gathered buffers
    (:class:`~repro_torch.kernels.sparse_margin.StepRows`).  Returns w.
    Ids must lie in their block (the kernel does not check)."""
    kernel = "lazy_touch_update" if corr is None else "lazy_proba_update"
    dev = _cuda_device(kernel, w)
    _build.require_tensor(kernel, "w", w, torch.float32, dev, (None,))
    _build.require_tensor(kernel, "z", z, torch.float32, dev, w.shape)
    _build.require_tensor(kernel, "coef", coef, torch.float32, dev, (None,))
    u = coef.shape[0]
    total = u * sum(rows.nnz[:q])
    _build.require_tensor(kernel, "indices", indices, torch.int32, dev, (total,))
    _build.require_tensor(kernel, "values", values, torch.float32, dev, (total,))
    scaled = ()
    if corr is not None:
        _build.require_tensor(kernel, "corr", corr, torch.float32, dev, w.shape)
        scaled = (corr.data_ptr(),)
    _launch(kernel, "repro_" + kernel, dev,
            ctypes.addressof(rows), q, indices.data_ptr(), values.data_ptr(), coef.data_ptr(),
            w.data_ptr(), z.data_ptr(), *scaled, u, float(eta), float(lam), float(lam1),
            float(lam2))
    return w


def lazy_touch_update(
    w: torch.Tensor,  # float32[d_block], updated in place
    indices: torch.Tensor,
    values: torch.Tensor,
    coef: torch.Tensor,
    z: torch.Tensor,
    eta: float,
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """One block's touch update through the kernel: the q = 1 case over the
    rows ``indices``; returns w."""
    rows = _build.block_rows("lazy_touch_update", (indices,), (values,), w.shape, w.device)
    return touch_update(rows, 1, indices.reshape(-1), values.reshape(-1), coef, w, z, eta,
                        lam, lam1, lam2)


def lazy_flush(
    w: torch.Tensor,  # float32[d_block], updated in place
    last: torch.Tensor,  # int32[d_block]
    z: torch.Tensor,
    eta: float,
    total: int,
    stop: int,
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """Launch the flush kernel on the current stream; returns w."""
    dev = _cuda_device("lazy_flush", w)
    _build.require_tensor("lazy_flush", "w_block", w, torch.float32, dev, (None,))
    (d,) = w.shape
    _build.require_tensor("lazy_flush", "last", last, torch.int32, dev, (d,))
    _build.require_tensor("lazy_flush", "z_block", z, torch.float32, dev, (d,))
    _launch("lazy_flush", "repro_lazy_flush", dev,
            w.data_ptr(), last.data_ptr(), z.data_ptr(), d, float(eta), int(total),
            int(stop), float(lam), float(lam1), float(lam2))
    return w


def lazy_proba_update(
    w: torch.Tensor,  # float32[d_block], updated in place
    indices: torch.Tensor,
    values: torch.Tensor,
    coef: torch.Tensor,
    z: torch.Tensor,
    corr: torch.Tensor,  # float32[d_block]
    eta: float,
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """One block's probabilistic update through the touched pass's kernel
    (the q = 1 case over the rows ``indices``); returns w."""
    rows = _build.block_rows("lazy_proba_update", (indices,), (values,), w.shape, w.device)
    return touch_update(rows, 1, indices.reshape(-1), values.reshape(-1), coef, w, z, eta,
                        lam, lam1, lam2, corr)
