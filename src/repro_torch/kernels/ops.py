"""Public wrappers around the kernels, dispatching on the tensors' device.

Port of ``repro.kernels.ops`` for the kernels of the FD-SVRG main path
(with the port's own entries over all q blocks in one launch: the step's
and the snapshot's margins, the step's catch-up and touched pass and the
snapshot scatter; a step's and a snapshot's loss coefficients), its lazy inner
steps (the epoch-end flush over the whole width in one launch), the
dense-layout step and LM decode attention (with split-K across the ranks
of a cache split by position).  On a CUDA tensor each
wrapper launches its hand-written kernel (or raises);
on a CPU tensor it takes the kernel's plain PyTorch version.  There is
no fallback from one to the other.  The reference's TPU-only keywords
(``block_rows``, ``block_k``, ``block_n``, ``block``, ``block_s``,
``interpret``) have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import block_scatter as _scatter
from repro_torch.kernels import fd_matvec as _matvec
from repro_torch.kernels import flash_decode as _decode
from repro_torch.kernels import fused_update as _fused
from repro_torch.kernels import lazy_update as _lazy
from repro_torch.kernels import logistic_grad as _logistic
from repro_torch.kernels import prox_update as _prox
from repro_torch.kernels import sparse_margin as _margin
from repro_torch.kernels import svrg_update as _svrg
from repro_torch.kernels.lazy_update import step_corrections
from repro_torch.kernels.sparse_margin import StepRows


def _route(t: torch.Tensor, kernel: str) -> bool:
    """True for the CUDA kernel, False for the plain version on the CPU."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


def sparse_margins(
    indices: torch.Tensor,  # int32[N, nnz_l], block-LOCAL ids (BlockCSR rows)
    values: torch.Tensor,  # float32[N, nnz_l]
    w_block: torch.Tensor,  # float32[d_block]
) -> torch.Tensor:  # float32[N]
    """Fused gather-margin over one block's local CSR rows (the one-block
    case of :func:`step_margins`' kernel)."""
    if _route(w_block, "sparse_margin"):
        return _margin.sparse_margin(indices, values, w_block)
    return _margin.sparse_margin_plain(indices, values, w_block)


class StepMargins(NamedTuple):
    s: torch.Tensor  # float32[u]: the margins, the partials summed in tree order
    rows: tuple[tuple[torch.Tensor, torch.Tensor], ...]  # block l's [u, nnz_l] ids, values
    parts: torch.Tensor | None  # float32[q, u] partials, if asked for


def _w_blocks(block_data, w: torch.Tensor) -> list[torch.Tensor]:
    bounds = block_data.partition.bounds
    return [w[bounds[l]:bounds[l + 1]] for l in range(block_data.num_blocks)]


def step_rows(block_data, u: int) -> StepRows:
    """Room for one step's gathered rows of ``block_data`` (u rows a block)
    on its device, for :func:`step_margins`' ``out``."""
    return _margin.step_rows(block_data.nnz_budgets, u, block_data.device)


def step_margins(
    block_data,  # BlockCSR: q blocks of rows on w's device
    ids: torch.Tensor,  # int64[u] the step's sampled rows
    w: torch.Tensor,  # float32[d], the q blocks' w concatenated
    *,
    partials: bool = False,
    out: StepRows | None = None,  # where the rows go (step_rows), reused step after step
) -> StepMargins:
    """The margins of a step's sampled rows (Alg 1 lines 9-10): each
    block's rows gathered by ``ids``, their partial margins, and the sum in
    tree order.  On the card ONE launch for all q blocks, which also writes
    the gathered rows (into ``out``, else new buffers) and, with
    ``partials``, the q partials; on the CPU the plain version, its rows
    copied into ``out`` if given."""
    if _route(w, "sparse_margin"):
        q, u = block_data.num_blocks, ids.shape[0]
        if w.shape != (block_data.dim,):
            raise ValueError(f"sparse_margin: w has shape {tuple(w.shape)}, "
                             f"expected ({block_data.dim},)")
        if w.device != block_data.device:
            raise ValueError(f"sparse_margin: w is on {w.device}, the rows on {block_data.device}")
        if out is None:
            out = step_rows(block_data, u)
        parts = torch.empty((q, u), dtype=torch.float32, device=w.device) if partials else None
        s = _margin.margins(block_data.block_rows(), q, w, ids, u, parts, out)
        return StepMargins(s, out.blocks, parts)
    s, parts, rows = _margin.margins_plain(block_data.indices, block_data.values,
                                           _w_blocks(block_data, w), ids)
    if out is not None:
        for (ri, rv), (oi, ov) in zip(rows, out.blocks, strict=True):
            oi.copy_(ri)
            ov.copy_(rv)
        rows = out.blocks
    return StepMargins(s, tuple(rows), torch.stack(parts) if partials else None)


def snapshot_margins(
    block_data,  # BlockCSR: q blocks of rows on w's device
    w: torch.Tensor,  # float32[d], the q blocks' w concatenated
) -> torch.Tensor:  # float32[N]
    """The snapshot's margins of every row (Alg 1 lines 3-4), the q
    partials summed in tree order: on the card ONE launch for all q
    blocks; on the CPU the plain version."""
    if _route(w, "sparse_margin"):
        if w.shape != (block_data.dim,) or w.device != block_data.device:
            raise ValueError(f"sparse_margin: w {tuple(w.shape)} on {w.device} does not fit "
                             f"rows of {block_data.dim} features on {block_data.device}")
        return _margin.margins(block_data.block_rows(), block_data.num_blocks, w, None,
                               block_data.num_instances)
    return _margin.margins_plain(block_data.indices, block_data.values,
                                 _w_blocks(block_data, w))[0]


def snapshot_scatter(
    block_data,  # BlockCSR: q blocks of rows on the coefficients' device
    coeffs: torch.Tensor,  # float32[N]
) -> torch.Tensor:  # float32[d], the q blocks' z concatenated
    """Every block's scatter of the full gradient (Alg 1 line 5), each id's
    terms added in flat order: on the card ONE launch for all q blocks
    over ``block_data.snapshot_index()``; on the CPU each block's plain
    version, concatenated."""
    if _route(coeffs, "block_scatter"):
        return _scatter.block_scatter(
            block_data.values, coeffs, block_data.snapshot_index()
        )
    z_blocks = [
        _scatter.block_scatter_plain(idx, val, coeffs, dim)
        for idx, val, dim in zip(block_data.indices, block_data.values, block_data.block_dims)
    ]
    return torch.cat(z_blocks) if len(z_blocks) > 1 else z_blocks[0]


def block_scatter(
    indices: torch.Tensor,  # int32[N, nnz_l], block-LOCAL ids
    values: torch.Tensor,  # float32[N, nnz_l]
    coeffs: torch.Tensor,  # float32[N]
    block_dim: int,
    index: _scatter.ScatterIndex,  # scatter_index of these rows, on their device
) -> torch.Tensor:  # float32[block_dim]
    """One block's scatter of every row, ``sum_i coeffs_i * x_i``, each id's
    terms added in flat order: on the card ONE launch of the snapshot
    scatter's kernel over ``index`` (the one-block case of
    :func:`snapshot_scatter`); on the CPU the plain version."""
    if _route(coeffs, "block_scatter"):
        return _scatter.block_scatter(values, coeffs, index)
    return _scatter.block_scatter_plain(indices, values, coeffs, block_dim)


def step_coef(
    block_data,  # BlockCSR: its labels on s0's device
    ids: torch.Tensor,  # int64[u] the step's sampled rows
    s_m: torch.Tensor,  # float32[u] the step's margins
    s0: torch.Tensor,  # float32[N] the snapshot's margins
    u_t: torch.Tensor,  # float32 0-dim on s_m's device: u, the divisor
    loss,  # MarginLoss
) -> torch.Tensor:  # float32[u]
    """A step's coefficients ``(dl(s_m, y) - dl(s0[ids], y)) / u_t`` with
    ``y = labels[ids]``.  Chosen on ``loss.name``: the logistic loss on a
    CUDA tensor takes ONE launch of the coefficient kernel (gathers, both
    derivatives, subtraction and division by ``u_t`` inside), on the CPU
    its plain version; the squared hinge, hinge and squared losses, for
    which no TPU kernel exists, take the chain of PyTorch ops on every
    device."""
    labels = block_data.labels
    if loss.name == "logistic" and _route(s_m, "logistic_grad"):
        return _logistic.step_coef(s_m, ids, labels, s0, u_t)
    return _logistic.step_coef_plain(s_m, ids, labels, s0, u_t, loss.dvalue)


def snapshot_coef(
    block_data,  # BlockCSR: its labels on s0's device
    s0: torch.Tensor,  # float32[N] the snapshot's margins
    loss,  # MarginLoss
) -> torch.Tensor:  # float32[N]
    """A snapshot's coefficients ``dl(s0, labels) / N`` (a true division),
    routed as :func:`step_coef`: one launch for the logistic loss on the
    card, its plain version on the CPU, the PyTorch chain for the other
    losses."""
    n = block_data.num_instances
    if loss.name == "logistic" and _route(s0, "logistic_grad"):
        return _logistic.snapshot_coef(s0, block_data.labels, n)
    return _logistic.snapshot_coef_plain(s0, block_data.labels, n, loss.dvalue)


def fused_block_update(
    w_block: torch.Tensor,  # float32[d_block]
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids
    values: torch.Tensor,  # float32[u, nnz_l]
    coef: torch.Tensor,  # float32[u]
    z_block: torch.Tensor,  # float32[d_block]
    eta: float,  # host scalar (eta * option mask), rounded to float32 here
    *,
    lam: float,
    out: torch.Tensor | None = None,  # float32[d_block], may be w_block itself
) -> torch.Tensor:  # float32[d_block]: out, or a new tensor
    """w - eta * (scatter(coef * x) + z + lam * w) on one block (L2
    family; lam = 0 covers the unregularized path).  With ``out =
    w_block`` the block is updated in place."""
    eta = float(np.float32(eta))
    if _route(w_block, "fused_update"):
        return _fused.fused_update(w_block, indices, values, coef, z_block, eta, lam, out)
    new = _fused.fused_update_plain(w_block, indices, values, coef, z_block, eta, lam)
    return new if out is None else out.copy_(new)


def fused_block_prox_update(
    w_block: torch.Tensor,  # float32[d_block]
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids
    values: torch.Tensor,  # float32[u, nnz_l]
    coef: torch.Tensor,  # float32[u]
    z_block: torch.Tensor,  # float32[d_block]
    eta: float,  # host scalar (eta * option mask), rounded to float32 here
    *,
    lam: float,  # smooth L2 coefficient (the classic 'l2' path)
    lam1: float = 0.0,  # L1 strength handled by the fused prox
    lam2: float = 0.0,  # elastic-net L2 strength handled by the fused prox
    out: torch.Tensor | None = None,  # float32[d_block], may be w_block itself
) -> torch.Tensor:  # float32[d_block]: out, or a new tensor
    """prox_{eta*g}(w - eta * (scatter(coef * x) + z + lam * w)) on one block.

    ``eta`` is a host float (never a device tensor, so the call does not
    wait on the card); like the reference's float32 operand it is rounded
    to float32 first.  ``lam1 = lam2 = 0`` skips the prox stages.  With
    ``out = w_block`` the block is updated in place.
    """
    eta = float(np.float32(eta))
    if _route(w_block, "prox_update"):
        return _prox.prox_update(
            w_block, indices, values, coef, z_block, eta, lam, lam1, lam2, out
        )
    new = _prox.prox_update_plain(
        w_block, indices, values, coef, z_block, eta, lam, lam1, lam2
    )
    return new if out is None else out.copy_(new)


# The lazy (delayed-decay) inner steps.  Each updates ``w_block`` (and
# ``last_block``) IN PLACE and returns it: the port's step stays
# O(u * nnz_l), with no copy of the block.  ``eta`` is a host float,
# rounded to float32 here; ``m``, ``stop`` and ``total`` are host ints, so
# no call waits on the card.


def lazy_block_catchup(
    w_block: torch.Tensor,  # float32[d_block], updated in place
    last_block: torch.Tensor,  # int32[d_block], updated in place
    z_block: torch.Tensor,  # float32[d_block]
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids
    eta: float,  # UNMASKED step size
    m: int,  # current inner-step index
    stop: int,  # number of active (unmasked) steps this epoch
    *,
    lam: float,  # smooth strength
    lam1: float = 0.0,
    lam2: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-lazy catch-up: replay the deferred decay of every feature
    touched at inner step ``m``; returns the caught-up block and ``last``."""
    eta = float(np.float32(eta))
    if _route(w_block, "lazy_catchup"):
        return _lazy.lazy_catchup(
            w_block, last_block, z_block, indices, eta, m, stop, lam, lam1, lam2
        )
    return _lazy.lazy_catchup_plain(
        w_block, last_block, z_block, indices, eta, m, stop, lam, lam1, lam2
    )


def lazy_step_catchup(
    block_data,  # BlockCSR: q blocks of rows on w's device
    ids: torch.Tensor,  # int64[u] the step's sampled rows
    w: torch.Tensor,  # float32[d], the q blocks' w concatenated; in place
    last: torch.Tensor,  # int32[d]; in place
    z: torch.Tensor,  # float32[d]
    eta: float,  # UNMASKED step size
    m: int,  # current inner-step index
    stop: int,  # number of active (unmasked) steps this epoch
    *,
    lam: float,
    lam1: float = 0.0,
    lam2: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-lazy catch-up of a step's sampled rows in every block (each
    block's ids replayed as :func:`lazy_block_catchup` replays them): on the
    card ONE launch for all q blocks, on the CPU the plain version block
    after block.  Returns (w, last)."""
    eta = float(np.float32(eta))
    if _route(w, "lazy_catchup"):
        if w.device != block_data.device:
            raise ValueError(f"lazy_catchup: w is on {w.device}, the rows on {block_data.device}")
        if w.shape != (block_data.dim,):
            raise ValueError(f"lazy_catchup: w has shape {tuple(w.shape)}, "
                             f"expected ({block_data.dim},)")
        return _lazy.catchup(block_data.block_rows(), block_data.num_blocks, ids,
                             ids.shape[0], w, last, z, eta, m, stop, lam, lam1, lam2)
    return _lazy.catchup_plain(block_data.indices, block_data.partition.bounds, ids, w, last,
                               z, eta, m, stop, lam, lam1, lam2)


def lazy_block_touch_update(
    w_block: torch.Tensor,  # float32[d_block], caught up at the touched ids
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids
    values: torch.Tensor,  # float32[u, nnz_l]
    coef: torch.Tensor,  # float32[u]
    z_block: torch.Tensor,  # float32[d_block]
    eta: float,  # masked step size (eta * option mask)
    *,
    lam: float,
    lam1: float = 0.0,
    lam2: float = 0.0,
) -> torch.Tensor:
    """Exact-lazy eager half-step: the dense prox update evaluated only at
    the touched features — O(u * nnz_l) instead of O(d_block)."""
    eta = float(np.float32(eta))
    if _route(w_block, "lazy_touch_update"):
        return _lazy.lazy_touch_update(
            w_block, indices, values, coef, z_block, eta, lam, lam1, lam2
        )
    return _lazy.lazy_touch_update_plain(
        w_block, indices, values, coef, z_block, eta, lam, lam1, lam2
    )


def lazy_step_touch_update(
    block_data,  # BlockCSR: q blocks of rows on w's device
    rows: StepRows,  # the step's gathered rows (step_margins' ``out``)
    w: torch.Tensor,  # float32[d], the q blocks' w concatenated, caught up; in place
    z: torch.Tensor,  # float32[d]
    coef: torch.Tensor,  # float32[u] the step's coefficients
    eta: float,  # masked step size (eta * option mask)
    *,
    lam: float,
    lam1: float = 0.0,
    lam2: float = 0.0,
) -> torch.Tensor:
    """Exact-lazy eager half-step of a step's rows in every block (each
    block's touched features updated as :func:`lazy_block_touch_update`
    updates them): on the card ONE launch for all q blocks, on the CPU the
    plain version block after block.  Returns w."""
    eta = float(np.float32(eta))
    if _route(w, "lazy_touch_update"):
        if w.device != block_data.device:
            raise ValueError(f"lazy_touch_update: w is on {w.device}, the rows on "
                             f"{block_data.device}")
        if w.shape != (block_data.dim,):
            raise ValueError(f"lazy_touch_update: w has shape {tuple(w.shape)}, "
                             f"expected ({block_data.dim},)")
        return _lazy.touch_update(block_data.block_rows(), block_data.num_blocks, rows.indices,
                                  rows.values, coef, w, z, eta, lam, lam1, lam2)
    bounds = block_data.partition.bounds
    for l, (idx, val) in enumerate(rows.blocks):
        lo, hi = bounds[l], bounds[l + 1]
        _lazy.lazy_touch_update_plain(w[lo:hi], idx, val, coef, z[lo:hi], eta, lam, lam1, lam2)
    return w


def lazy_block_flush(
    w_block: torch.Tensor,  # float32[d_block], updated in place
    last_block: torch.Tensor,  # int32[d_block]
    z_block: torch.Tensor,  # float32[d_block]
    eta: float,  # UNMASKED step size
    total: int,  # total inner steps M this epoch
    stop: int,  # number of active steps
    *,
    lam: float,
    lam1: float = 0.0,
    lam2: float = 0.0,
) -> torch.Tensor:
    """Epoch-end reconciliation: replay every feature's deferred steps so
    the block equals the dense iterate after all M inner steps.  A
    feature's replay reads only its own w, last and z, so one call over
    the q blocks' tensors whole (the epoch's flush: on the card ONE
    launch over the d features) is the q one-block calls bit for bit."""
    eta = float(np.float32(eta))
    if _route(w_block, "lazy_flush"):
        return _lazy.lazy_flush(
            w_block, last_block, z_block, eta, total, stop, lam, lam1, lam2
        )
    return _lazy.lazy_flush_plain(
        w_block, last_block, z_block, eta, total, stop, lam, lam1, lam2
    )


def lazy_block_proba_update(
    w_block: torch.Tensor,  # float32[d_block], updated in place
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids
    values: torch.Tensor,  # float32[u, nnz_l]
    coef: torch.Tensor,  # float32[u]
    z_block: torch.Tensor,  # float32[d_block]
    corr_block: torch.Tensor,  # float32[d_block] step corrections
    eta: float,  # masked step size (eta * option mask)
    *,
    lam: float,
    lam1: float = 0.0,
    lam2: float = 0.0,
) -> torch.Tensor:
    """Probabilistic lazy step: touched features only, decay scaled by the
    per-feature corrections so the expected update is unbiased."""
    eta = float(np.float32(eta))
    if _route(w_block, "lazy_proba_update"):
        return _lazy.lazy_proba_update(
            w_block, indices, values, coef, z_block, corr_block, eta, lam, lam1, lam2
        )
    return _lazy.lazy_proba_update_plain(
        w_block, indices, values, coef, z_block, corr_block, eta, lam, lam1, lam2
    )


# The dense-layout step: margins of a dense [d, N] block, the fused
# logistic loss and derivative, and the dense L2 update.  ``eta`` and
# ``lam`` are host floats, so no call waits on the card.


def margins_dense(
    w: torch.Tensor,  # float32 or bfloat16 [d]
    data: torch.Tensor,  # same dtype [d, N], unit column stride, any row stride
) -> torch.Tensor:  # float32 [N]
    """S = wᵀD, the full-gradient-phase margins for one feature block; one
    column of a larger matrix, ``D[:, i:i+1]``, is read in place."""
    if _route(w, "fd_matvec"):
        return _matvec.fd_matvec(w, data)
    return _matvec.fd_matvec_plain(w, data)


def loss_and_grad(
    s: torch.Tensor,  # float32 or bfloat16 [N]
    y: torch.Tensor,  # same dtype [N]
) -> tuple[torch.Tensor, torch.Tensor]:  # float32 [N] loss, dloss
    """Fused logistic loss values + margin derivatives."""
    if _route(s, "logistic_grad"):
        return _logistic.logistic_grad(s, y)
    return _logistic.logistic_grad_plain(s, y)


def svrg_dense_update(
    w: torch.Tensor,  # float32[d]
    g_sparse: torch.Tensor,  # float32[d]
    z: torch.Tensor,  # float32[d]
    *,
    eta: float,
    lam: float,
) -> torch.Tensor:  # float32[d]
    """Fused w' = (1-eta*lam) w - eta (g_sparse + z)   (L2 path)."""
    if _route(w, "svrg_update"):
        return _svrg.svrg_update(w, g_sparse, z, eta, lam)
    return _svrg.svrg_update_plain(w, g_sparse, z, eta, lam)


def decode_attention(
    q: torch.Tensor,  # [H, Dh] one token's query heads
    k: torch.Tensor,  # [S, Hkv, Dh] cache
    v: torch.Tensor,  # [S, Hkv, Dh]
    *,
    length: int,  # valid cache prefix
    scale: float | None = None,
) -> torch.Tensor:  # float32 [H, Dh]
    """Flash-decoding over the KV cache (one token, GQA): the batched
    form with B = 1."""
    h, dh = q.shape
    s, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f"decode_attention: {h} heads over {hkv} KV heads")
    qg = q.reshape(1, hkv, h // hkv, dh)
    out = decode_attention_batched(qg, k[None], v[None], length=length, scale=scale)
    return out.reshape(h, dh)


def decode_attention_batched(
    q: torch.Tensor,  # [B, Hkv, G, Dh], head h = j * G + g
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    *,
    length: int,  # valid prefix, the same for the whole batch
    scale: float | None = None,
    softcap: float | None = None,  # attention logit softcap on the scaled scores
    window: int | None = None,  # sliding window: positions >= length - window
) -> torch.Tensor:  # float32 [B, Hkv, G, Dh]
    """One decode step's attention for a batch of requests at one layer:
    the kernel (one counted launch) on the card, its plain version on the
    CPU.  ``length`` is a host int in ``[1, S]``."""
    length = int(length)
    if not 1 <= length <= k.shape[1]:
        raise ValueError(f"decode_attention: length {length} outside [1, {k.shape[1]}]")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if _route(q, "flash_decode"):
        return _decode.flash_decode(q.contiguous(), k, v, length, scale, softcap=softcap,
                                    window=window)
    return _decode.flash_decode_plain(q, k, v, length, scale, softcap=softcap, window=window)


def decode_attention_partials(
    q: torch.Tensor,  # [B, Hkv, G, Dh], head h = j * G + g
    k: torch.Tensor,  # [B, S_r, Hkv, Dh]: this rank's shard of the cache's positions
    v: torch.Tensor,  # [B, S_r, Hkv, Dh]
    *,
    offset: int,  # the global position of the shard's first row
    length: int,  # the global valid prefix, the same for the whole batch
    scale: float | None = None,
    softcap: float | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:  # float32 m, l [B, Hkv, G]; acc
    """One rank's share of a decode step's attention over a cache split by
    position: its un-normalised ``(m, l, acc)`` over the global positions
    ``[max(0, length - window), length)`` that its shard ``[offset, offset
    + S_r)`` holds (the window's start reckoned in global positions, then
    clamped to the shard).  The kernel in partials mode on the card (one
    counted launch, none when the shard holds no such row), its plain
    version on the CPU.  :func:`decode_attention_merge` combines the
    ranks' partials."""
    length, offset = int(length), int(offset)
    if length < 1 or offset < 0:
        raise ValueError(f"decode_attention_partials: length {length} (>= 1) and offset "
                         f"{offset} (>= 0) not taken")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention_partials: window {window} must be at least 1")
    rows = k.shape[1]
    start = min(max(_decode.window_start(length, window) - offset, 0), rows)
    stop = min(max(length - offset, 0), rows)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if _route(q, "flash_decode"):
        return _decode.flash_decode_partials(q.contiguous(), k, v, start, stop, scale,
                                             softcap=softcap)
    return _decode.flash_decode_partials_plain(q, k, v, start, stop, scale, softcap=softcap)


def decode_attention_merge(
    m: torch.Tensor,  # float32 [R, B, Hkv, G], the ranks' partials in rank order
    l: torch.Tensor,  # float32 [R, B, Hkv, G]
    acc: torch.Tensor,  # float32 [R, B, Hkv, G, Dh]
) -> torch.Tensor:  # float32 [B, Hkv, G, Dh]
    """The ranks' partials combined in rank order and divided by ``max(l,
    1e-30)``: the merge kernel (one counted launch) on the card, its plain
    version on the CPU."""
    if _route(m, "flash_decode_merge"):
        return _decode.flash_decode_merge(m.contiguous(), l.contiguous(), acc.contiguous())
    return _decode.flash_decode_merge_plain(m, l, acc)


_COUNTED = (_scatter, _margin, _prox, _fused, _matvec, _logistic, _svrg, _decode)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {
        "sparse_margin": _margin.launches,
        "block_scatter": _scatter.launches,
        "prox_update": _prox.launches,
        **_lazy.launches,
        "fused_update": _fused.launches,
        "fd_matvec": _matvec.launches,
        "logistic_grad": _logistic.launches,
        "svrg_update": _svrg.launches,
        "flash_decode": _decode.launches,
        "flash_decode_merge": _decode.merge_launches,
    }


def reset_launch_counts() -> None:
    for mod in _COUNTED:
        mod.launches = 0
    _decode.merge_launches = 0
    for name in _lazy.launches:
        _lazy.launches[name] = 0


__all__ = [
    "block_scatter",
    "decode_attention",
    "decode_attention_batched",
    "decode_attention_merge",
    "decode_attention_partials",
    "fused_block_prox_update",
    "fused_block_update",
    "launch_counts",
    "lazy_block_catchup",
    "lazy_block_flush",
    "lazy_block_proba_update",
    "lazy_block_touch_update",
    "lazy_step_catchup",
    "lazy_step_touch_update",
    "loss_and_grad",
    "margins_dense",
    "reset_launch_counts",
    "snapshot_coef",
    "StepMargins",
    "StepRows",
    "snapshot_margins",
    "snapshot_scatter",
    "sparse_margins",
    "step_margins",
    "step_rows",
    "step_coef",
    "step_corrections",
    "svrg_dense_update",
]
