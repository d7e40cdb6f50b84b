"""Public wrappers around the kernels, dispatching on the tensors' device.

Port of ``repro.kernels.ops`` for the two kernels of the FD-SVRG main path.
On a CUDA tensor each wrapper launches its hand-written kernel (or
raises); on a CPU tensor it takes the kernel's plain PyTorch version.
There is no fallback from one to the other.  The reference's TPU-only
keywords (``block_rows``, ``interpret``) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import prox_update as _prox
from repro_torch.kernels import sparse_margin as _margin


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


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {"sparse_margin": _margin.launches, "prox_update": _prox.launches}


def reset_launch_counts() -> None:
    _margin.launches = 0
    _prox.launches = 0


__all__ = [
    "fused_block_prox_update",
    "launch_counts",
    "reset_launch_counts",
    "sparse_margins",
]
