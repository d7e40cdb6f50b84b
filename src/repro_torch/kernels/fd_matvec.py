"""fd_matvec: the margins of one dense feature block, ``S = wᵀD``.

    S[n] = sum_k w[k] * D[k, n]       w [d], D [d, N] row-major, S float32 [N]

The CUDA kernel (``csrc/fd_matvec.cu``) replaces the Pallas TPU kernel
``repro/kernels/fd_matvec.py::fd_matvec``, the full-gradient phase of the
dense layout.  ``w`` and ``D`` are float32 or bfloat16 (one dtype); the
products and sums are float32.  The kernel splits ``d`` into slices of
:func:`slice_rows` rows: one thread of a block of :data:`THREADS`
columns sums its slice in increasing ``k``, and a second launch adds the
slices' partials in order — no atomics, so the result is deterministic.
This module owns that geometry; the C side checks it only against the
launch limits (at most 1024 threads, 48 KB of staged ``w``, 65535
slices).  Beside it is
:func:`fd_matvec_plain`, ``w.float() @ D.float()`` (the CPU path and the
card-side yardstick; on the card it needs TF32 off, PyTorch's default).

Stated tolerance, kernel vs plain: ``|d| <= 1e-5 * sum_k |w[k] * D[k, n]|``
per column (the two sum in different orders).  ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

THREADS = 256  # columns per block of the partial-sum launch
MAX_SLICE_ROWS = 4096  # 16 KB of staged w, so 8 blocks fit on an SM
BLOCKS_PER_SM = 4


def slice_rows(d: int, n: int, sms: int) -> int:
    """Rows of ``D`` per slice on a card of ``sms`` SMs: enough slices
    that the grid has about ``BLOCKS_PER_SM * sms`` blocks (the only
    parallelism at ``N = 1``), at most ``MAX_SLICE_ROWS`` and at least 64."""
    col_blocks = max(1, -(-n // THREADS))
    slices = max(1, -(-(BLOCKS_PER_SM * sms) // col_blocks))
    return min(MAX_SLICE_ROWS, max(64, -(-d // slices)))


def fd_matvec_plain(w: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one float32 matrix-vector product."""
    return w.float() @ data.float()


def fd_matvec(
    w: torch.Tensor,  # float32 or bfloat16 [d]
    data: torch.Tensor,  # same dtype [d, N], row-major
) -> torch.Tensor:  # float32 [N]
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape mismatch or a
    non-contiguous tensor (pass ``D[:, i:i+1].contiguous()`` for one
    column).
    """
    global launches
    if not w.is_cuda:
        raise ValueError("fd_matvec: the CUDA kernel needs CUDA tensors")
    dev = w.device
    code = _build.float_code("fd_matvec", "w", w)
    _build.require_tensor("fd_matvec", "w", w, w.dtype, dev, (None,))
    (d,) = w.shape
    _build.require_tensor("fd_matvec", "data", data, w.dtype, dev, (d, None))
    n = data.shape[1]
    rows = slice_rows(d, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((-(-d // rows), n), dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_fd_matvec(
            w.data_ptr(), data.data_ptr(), partial.data_ptr(), out.data_ptr(),
            d, n, rows, THREADS, code, stream,
        )
    _build.check(rc, "fd_matvec")
    launches += 1
    return out
