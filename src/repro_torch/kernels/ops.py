"""Public wrappers around the kernels, dispatching on the tensors' device.

Port of ``repro.kernels.ops`` for the kernels of the FD-SVRG main path
(with the port's own snapshot scatter), its lazy inner steps, the
dense-layout step and LM decode attention.  On a CUDA tensor each
wrapper launches its hand-written kernel (or raises);
on a CPU tensor it takes the kernel's plain PyTorch version.  There is
no fallback from one to the other.  The reference's TPU-only keywords
(``block_rows``, ``block_k``, ``block_n``, ``block``, ``block_s``,
``interpret``) have no counterpart here.
"""

from __future__ import annotations

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
    """Fused gather-margin over one block's local CSR rows."""
    if _route(w_block, "sparse_margin"):
        return _margin.sparse_margin(indices, values, w_block)
    return _margin.sparse_margin_plain(indices, values, w_block)


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


def fused_block_update(
    w_block: torch.Tensor,  # float32[d_block]
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids
    values: torch.Tensor,  # float32[u, nnz_l]
    coef: torch.Tensor,  # float32[u]
    z_block: torch.Tensor,  # float32[d_block]
    eta: float,  # host scalar (eta * option mask), rounded to float32 here
    *,
    lam: float,
) -> torch.Tensor:  # float32[d_block]
    """w - eta * (scatter(coef * x) + z + lam * w) on one block (L2
    family; lam = 0 covers the unregularized path)."""
    eta = float(np.float32(eta))
    if _route(w_block, "fused_update"):
        return _fused.fused_update(w_block, indices, values, coef, z_block, eta, lam)
    return _fused.fused_update_plain(w_block, indices, values, coef, z_block, eta, lam)


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
) -> torch.Tensor:  # float32[d_block]
    """prox_{eta*g}(w - eta * (scatter(coef * x) + z + lam * w)) on one block.

    ``eta`` is a host float (never a device tensor, so the call does not
    wait on the card); like the reference's float32 operand it is rounded
    to float32 first.  ``lam1 = lam2 = 0`` skips the prox stages.
    """
    eta = float(np.float32(eta))
    if _route(w_block, "prox_update"):
        return _prox.prox_update(
            w_block, indices, values, coef, z_block, eta, lam, lam1, lam2
        )
    return _prox.prox_update_plain(
        w_block, indices, values, coef, z_block, eta, lam, lam1, lam2
    )


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
    the block equals the dense iterate after all M inner steps."""
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
) -> torch.Tensor:  # float32 [B, Hkv, G, Dh]
    """One decode step's attention for a batch of requests at one layer:
    the kernel (one counted launch) on the card, its plain version on the
    CPU.  ``length`` is a host int in ``[1, S]``."""
    length = int(length)
    if not 1 <= length <= k.shape[1]:
        raise ValueError(f"decode_attention: length {length} outside [1, {k.shape[1]}]")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if _route(q, "flash_decode"):
        return _decode.flash_decode(q.contiguous(), k, v, length, scale)
    return _decode.flash_decode_plain(q, k, v, length, scale)


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
    }


def reset_launch_counts() -> None:
    for mod in _COUNTED:
        mod.launches = 0
    for name in _lazy.launches:
        _lazy.launches[name] = 0


__all__ = [
    "decode_attention",
    "decode_attention_batched",
    "fused_block_prox_update",
    "fused_block_update",
    "launch_counts",
    "lazy_block_catchup",
    "lazy_block_flush",
    "lazy_block_proba_update",
    "lazy_block_touch_update",
    "loss_and_grad",
    "margins_dense",
    "reset_launch_counts",
    "snapshot_scatter",
    "sparse_margins",
    "step_corrections",
    "svrg_dense_update",
]
