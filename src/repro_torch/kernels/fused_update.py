"""fused_update: fused scatter-grad + variance-reduced block update, L2 family.

    g   = scatter(coef * x)                 (u sampled rows, local ids)
    out = w - eta * ((g + z) + lam * w)

The CUDA kernel (``csrc/fused_update.cu``) replaces the Pallas TPU kernel
``repro/kernels/fused_update.py::fused_update``.  It is
:mod:`repro_torch.kernels.prox_update` with both prox strengths zero: the
same dense step and deterministic flat-order touched pass of
``csrc/touched.cuh``, so it equals the ``prox_update`` kernel at
``lam1 = lam2 = 0`` bit for bit (the reference pins the same equality).
Beside it is :func:`fused_update_plain`, ``prox_update_plain`` with zero
prox strengths.  Stated tolerance, kernel vs plain on the card: ``|d| <=
1e-7 + 1e-6 * (|w| + |plain| + eta * (|g| + |z| + lam * |w|))``, ``|g|``
the sum of a feature's ``|contributions|`` (the plain ``index_add_`` adds
repeated ids with atomics, in another order than the kernel's flat one).
``eta`` and ``lam`` are runtime floats; ``launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prox_update import prox_update_plain

launches = 0


def fused_update_plain(
    w_block: torch.Tensor,
    indices: torch.Tensor,
    values: torch.Tensor,
    coef: torch.Tensor,
    z_block: torch.Tensor,
    eta: float,
    lam: float,
) -> torch.Tensor:
    """The plain PyTorch version: ``prox_update_plain`` with no prox."""
    return prox_update_plain(w_block, indices, values, coef, z_block, eta, lam, 0.0, 0.0)


def fused_update(
    w_block: torch.Tensor,  # float32[d_block]
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids in [0, d_block)
    values: torch.Tensor,  # float32[u, nnz_l]
    coef: torch.Tensor,  # float32[u]
    z_block: torch.Tensor,  # float32[d_block]
    eta: float,
    lam: float,
) -> torch.Tensor:  # float32[d_block], a new tensor
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape mismatch or a
    non-contiguous tensor.  The floats travel by value, so the call never
    waits on the card.
    """
    global launches
    if not w_block.is_cuda:
        raise ValueError("fused_update: the CUDA kernel needs CUDA tensors")
    dev = w_block.device
    _build.require_tensor("fused_update", "w_block", w_block, torch.float32, dev, (None,))
    _build.require_tensor("fused_update", "indices", indices, torch.int32, dev, (None, None))
    (d,), (u, nnz) = w_block.shape, indices.shape
    _build.require_tensor("fused_update", "z_block", z_block, torch.float32, dev, (d,))
    _build.require_tensor("fused_update", "values", values, torch.float32, dev, (u, nnz))
    _build.require_tensor("fused_update", "coef", coef, torch.float32, dev, (u,))
    out = torch.empty_like(w_block)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_fused_update(
            w_block.data_ptr(), indices.data_ptr(), values.data_ptr(),
            coef.data_ptr(), z_block.data_ptr(), out.data_ptr(),
            d, u, nnz, float(eta), float(lam), stream,
        )
    _build.check(rc, "fused_update")
    launches += 1
    return out
