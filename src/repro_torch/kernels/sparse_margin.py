"""sparse_margin: fused gather-margin over block-local padded CSR rows.

    s_i = sum_k w[idx[i, k]] * val[i, k]

The CUDA kernel (``csrc/sparse_margin.cu``, one warp per row, each lane a
sequential ``fmaf`` chain, then a shuffle tree) replaces the Pallas TPU
kernel ``repro/kernels/sparse_margin.py::sparse_margin``.  Beside it is
:func:`sparse_margin_plain`, the plain PyTorch version of the same
function: the CPU path and the card-side yardstick.  ``launches`` counts
the kernel's launches (the wrapper adds one per launch and nowhere else).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def sparse_margin_plain(
    indices: torch.Tensor, values: torch.Tensor, w_block: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: ``torch.sum(w[idx] * val, -1)``."""
    return torch.sum(w_block[indices] * values, dim=-1)


def sparse_margin(
    indices: torch.Tensor,  # int32[R, nnz_l], block-LOCAL ids in [0, d_block)
    values: torch.Tensor,  # float32[R, nnz_l]
    w_block: torch.Tensor,  # float32[d_block]
) -> torch.Tensor:  # float32[R]
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on anything the kernel does not take: a CPU tensor, another
    dtype, a shape mismatch or a non-contiguous tensor.  Ids must lie in
    ``[0, d_block)`` (a BlockCSR guarantees it; the kernel does not check).
    """
    global launches
    if not w_block.is_cuda:
        raise ValueError("sparse_margin: the CUDA kernel needs CUDA tensors")
    dev = w_block.device
    _build.require_tensor("sparse_margin", "w_block", w_block, torch.float32, dev, (None,))
    _build.require_tensor("sparse_margin", "indices", indices, torch.int32, dev, (None, None))
    rows, nnz = indices.shape
    _build.require_tensor("sparse_margin", "values", values, torch.float32, dev, (rows, nnz))
    out = torch.empty((rows,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_sparse_margin(
            w_block.data_ptr(), indices.data_ptr(), values.data_ptr(),
            out.data_ptr(), rows, nnz, stream,
        )
    _build.check(rc, "sparse_margin")
    launches += 1
    return out
