"""prox_update: fused scatter-grad + proximal variance-reduced block update.

    g   = scatter(coef * x)                 (u sampled rows, local ids)
    v   = w - eta * ((g + z) + lam * w)
    out = sign(v) * max(|v| - eta*lam1, 0) [/ (1 + eta*lam2)]

The CUDA kernel (``csrc/prox_update.cu``) replaces the Pallas TPU kernel
``repro/kernels/prox_update.py::prox_update``.  Its scatter accumulates
each feature's contributions in increasing flat position of the
``[u, nnz_l]`` rows, starting from 0.0 — the order of the reference's
``.at[].add`` — with no float atomics, so it is deterministic.  Beside it
is :func:`prox_update_plain` (``index_add_`` plus the elementwise
expression), the CPU path and the card-side yardstick.  ``eta``, ``lam``,
``lam1`` and ``lam2`` are runtime floats; ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0


def _f32(x: float) -> np.float32:
    return np.float32(x)


def prox_update_plain(
    w_block: torch.Tensor,
    indices: torch.Tensor,
    values: torch.Tensor,
    coef: torch.Tensor,
    z_block: torch.Tensor,
    eta: float,
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:
    """The plain PyTorch version, in the kernel's float32 operation order.

    ``eta * lam1`` and ``1 + eta * lam2`` are rounded in float32 as the
    reference does; the shrink divides by a device tensor, because a
    division by a Python scalar on a CUDA tensor multiplies by its
    reciprocal instead.
    """
    contrib = (values * coef[:, None]).reshape(-1)
    g = torch.zeros_like(w_block).index_add_(0, indices.reshape(-1), contrib)
    v = w_block - eta * ((g + z_block) + lam * w_block)
    if lam1 != 0.0 or lam2 != 0.0:
        thr = float(_f32(eta) * _f32(lam1))
        v = torch.sign(v) * torch.clamp_min(torch.abs(v) - thr, 0.0)
        if lam2 != 0.0:
            den = float(_f32(1.0) + _f32(eta) * _f32(lam2))
            v = v / torch.full((), den, dtype=v.dtype, device=v.device)
    return v


def prox_update(
    w_block: torch.Tensor,  # float32[d_block]
    indices: torch.Tensor,  # int32[u, nnz_l], block-LOCAL ids in [0, d_block)
    values: torch.Tensor,  # float32[u, nnz_l]
    coef: torch.Tensor,  # float32[u]
    z_block: torch.Tensor,  # float32[d_block]
    eta: float,
    lam: float,
    lam1: float,
    lam2: float,
) -> torch.Tensor:  # float32[d_block], a new tensor
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape mismatch or a
    non-contiguous tensor.  The float arguments travel by value, so the
    call never waits on the card.
    """
    global launches
    if not w_block.is_cuda:
        raise ValueError("prox_update: the CUDA kernel needs CUDA tensors")
    dev = w_block.device
    _build.require_tensor("prox_update", "w_block", w_block, torch.float32, dev, (None,))
    _build.require_tensor("prox_update", "indices", indices, torch.int32, dev, (None, None))
    (d,), (u, nnz) = w_block.shape, indices.shape
    _build.require_tensor("prox_update", "z_block", z_block, torch.float32, dev, (d,))
    _build.require_tensor("prox_update", "values", values, torch.float32, dev, (u, nnz))
    _build.require_tensor("prox_update", "coef", coef, torch.float32, dev, (u,))
    out = torch.empty_like(w_block)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_prox_update(
            w_block.data_ptr(), indices.data_ptr(), values.data_ptr(),
            coef.data_ptr(), z_block.data_ptr(), out.data_ptr(),
            d, u, nnz, float(eta), float(lam), float(lam1), float(lam2), stream,
        )
    _build.check(rc, "prox_update")
    launches += 1
    return out
