"""fd_matvec: the margins of one dense feature block, ``S = wᵀD``.

    S[n] = sum_k w[k] * D[k, n]       w [d], D [d, N], S float32 [N]

The CUDA kernel (``csrc/fd_matvec.cu``) replaces the Pallas TPU kernel
``repro/kernels/fd_matvec.py::fd_matvec``, the full-gradient phase of the
dense layout.  ``w`` and ``D`` are float32 or bfloat16 (one dtype); the
products and sums are float32.  ``D`` has unit column stride and any row
stride, so one column of a larger matrix, ``D[:, i:i+1]``, is read in
place.  One launch: a grid of column blocks × row slices, each block
summing its slice in increasing ``k`` (its threads split the rows at
small ``N`` and add in a fixed tree), and the last block of a column
block to finish adds the slices' partials in slice order — no float
atomics, so the result is deterministic.  This module owns the geometry
(:func:`geometry`: the load width, the threads along the columns and the
slice rows, from ``N``, the row stride and the card's SM count) and the
per-stream ticket counters the last block takes.  Beside it is
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

THREADS = 256  # threads per block: TX along the columns, TY = THREADS / TX along the rows
MAX_LOAD_BYTES = 16  # a thread's columns in one row: one load of at most 16 bytes
SHARED_BYTES = 48 * 1024 - 1088  # staged w plus the row tree's scratch, without opting in
BLOCKS_PER_SM = 64  # the grid aims at many waves of short blocks
MIN_ROWS_PER_THREAD = 8  # one unrolled batch of loads
MAX_SLICES = 65535

_tickets: dict[tuple[int, int], torch.Tensor] = {}


def geometry(d: int, n: int, ld: int, addr: int, elt: int, sms: int) -> tuple[int, int, int]:
    """``(vec, tx, slice_rows)`` for ``D [d, n]`` of ``elt``-byte elements
    at byte address ``addr`` with row stride ``ld`` elements, on a card of
    ``sms`` SMs.  ``vec``: the columns a thread loads at once, the widest
    power of two (at most ``MAX_LOAD_BYTES``) that ``n``, ``ld`` and the
    address allow.  ``tx``: threads along the columns, a power of two, just
    enough to cover ``n`` (1 at ``N = 1``).  ``slice_rows``: about
    ``BLOCKS_PER_SM * sms`` blocks, each thread at least
    ``MIN_ROWS_PER_THREAD`` rows, the staged rows and the tree's scratch
    within ``SHARED_BYTES``."""
    vec = MAX_LOAD_BYTES // elt
    while vec > 1 and (n % vec or ld % vec or addr % (vec * elt)):
        vec //= 2
    tx = 1
    while tx < THREADS and tx * vec < n:
        tx *= 2
    col_blocks = -(-n // (tx * vec))
    slices = max(1, (BLOCKS_PER_SM * sms) // col_blocks)
    rows = max(-(-d // slices), MIN_ROWS_PER_THREAD * (THREADS // tx))
    scratch = 4 * THREADS * vec if tx < THREADS else 0
    rows = min(rows, (SHARED_BYTES - scratch) // 4)
    rows = max(rows, -(-d // MAX_SLICES))
    return vec, tx, rows


def fd_matvec_plain(w: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one float32 matrix-vector product."""
    return w.float() @ data.float()


def _ticket_buffer(dev: torch.device, stream: int, size: int) -> torch.Tensor:
    """Zeroed int32 counters for this stream's launches (each launch leaves
    them zero again); calls on one stream run in order, so they share them."""
    key = (dev.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 1024), dtype=torch.int32, device=dev)
        _tickets[key] = buf
    return buf


def fd_matvec(
    w: torch.Tensor,  # float32 or bfloat16 [d]
    data: torch.Tensor,  # same dtype [d, N], unit column stride, any row stride
) -> torch.Tensor:  # float32 [N]
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape mismatch, a
    non-contiguous ``w``, or a ``D`` whose columns are not adjacent
    (``D[:, i:i+1]`` is taken as it is).
    """
    global launches
    if not w.is_cuda:
        raise ValueError("fd_matvec: the CUDA kernel needs CUDA tensors")
    dev = w.device
    code = _build.float_code("fd_matvec", "w", w)
    _build.require_tensor("fd_matvec", "w", w, w.dtype, dev, (None,))
    (d,) = w.shape
    if data.dtype != w.dtype or data.device != dev:
        raise TypeError(f"fd_matvec: data must be {w.dtype} on {dev}, got {data.dtype} on "
                        f"{data.device}")
    if data.dim() != 2 or data.shape[0] != d:
        raise ValueError(f"fd_matvec: data has shape {tuple(data.shape)}, expected ({d}, N)")
    n = data.shape[1]
    ld = data.stride(0) if d > 1 else n
    if d < 1 or n < 1 or (n > 1 and data.stride(1) != 1) or ld < n:
        raise ValueError(f"fd_matvec: data {tuple(data.shape)} with strides {data.stride()} "
                         f"not taken (d, N >= 1, unit column stride, row stride >= N)")
    vec, tx, rows = geometry(d, n, ld, data.data_ptr(), data.element_size(),
                             torch.cuda.get_device_properties(dev).multi_processor_count)
    col_blocks = -(-n // (tx * vec))
    partial = torch.empty((-(-d // rows), n), dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _ticket_buffer(dev, stream, col_blocks)
        rc = lib.repro_fd_matvec(
            w.data_ptr(), data.data_ptr(), partial.data_ptr(), out.data_ptr(),
            tickets.data_ptr(), d, n, ld, rows, tx.bit_length() - 1, vec, code, stream,
        )
    _build.check(rc, "fd_matvec")
    launches += 1
    return out
