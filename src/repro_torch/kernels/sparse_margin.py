"""sparse_margin: fused gather-margin over the q feature blocks' block-local padded CSR rows.

    parts[l, r] = sum_k w_l[idx_l[row(r), k]] * val_l[row(r), k]
    s[r]        = tree_order_sum over l of parts[l, r]

with ``row(r)`` the step's sampled row ids, or every row (the snapshot).
The CUDA kernel (``csrc/sparse_margin.cu``) replaces the Pallas TPU
kernel ``repro/kernels/sparse_margin.py::sparse_margin``, which FD-SVRG
runs once per block, and the tree sum and the row gathers around it: one
launch for all q blocks, a warp per (row, block) pair with each lane a
sequential ``fmaf`` chain and a shuffle tree (each partial bit for bit
the q = 1 launch's on that block), then the partials added in
``dist.tree.tree_order_sum``'s order.  On request it also writes the
partials and the step's gathered rows (:class:`StepRows`).
:func:`sparse_margin` is the one-block case.  Beside the kernel are the
plain PyTorch versions (:func:`sparse_margin_plain`,
:func:`margins_plain`): the CPU path and the card-side yardstick.
``launches`` counts the kernel's launches (the wrapper adds one per
launch and nowhere else).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.dist.tree import tree_order_sum
from repro_torch.kernels import _build

launches = 0


class StepRows(NamedTuple):
    """A step's gathered rows: block l's ``[u, nnz_l]`` ids and values,
    views of two flat buffers at ``u * sum(nnz[:l])``, which the kernel
    fills and the touched-pass kernels read."""

    indices: torch.Tensor  # int32[u * sum_l nnz_l]
    values: torch.Tensor  # float32[u * sum_l nnz_l]
    blocks: tuple[tuple[torch.Tensor, torch.Tensor], ...]


def step_rows(widths: Sequence[int], u: int, device) -> StepRows:
    """Room for the gathered rows of u sampled rows of blocks of these
    widths, on ``device`` (allocated once, filled step after step)."""
    total = u * sum(widths)
    idx = torch.empty((total,), dtype=torch.int32, device=device)
    val = torch.empty((total,), dtype=torch.float32, device=device)
    blocks, lo = [], 0
    for nnz in widths:
        hi = lo + u * nnz
        blocks.append((idx[lo:hi].view(u, nnz), val[lo:hi].view(u, nnz)))
        lo = hi
    return StepRows(idx, val, tuple(blocks))


def sparse_margin_plain(
    indices: torch.Tensor, values: torch.Tensor, w_block: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of one block: ``torch.sum(w[idx] * val, -1)``."""
    return torch.sum(w_block[indices] * values, dim=-1)


def margins_plain(
    indices: Sequence[torch.Tensor],  # per block: int32[N, nnz_l], local ids
    values: Sequence[torch.Tensor],  # per block: float32[N, nnz_l]
    w_blocks: Sequence[torch.Tensor],  # per block: float32[d_l]
    ids: torch.Tensor | None = None,  # int64[R] sampled rows, or None: all N
) -> tuple[torch.Tensor, list[torch.Tensor], list[tuple[torch.Tensor, torch.Tensor]]]:
    """The plain version of q blocks: (s, the q partials, the gathered rows)
    — each block's rows gathered by ``ids``, its partial margins, and their
    sum in tree order."""
    if ids is None:
        rows = list(zip(indices, values))
    else:
        rows = [(idx[ids], val[ids]) for idx, val in zip(indices, values)]
    parts = [sparse_margin_plain(i, v, w_l) for (i, v), w_l in zip(rows, w_blocks, strict=True)]
    return tree_order_sum(parts), parts, rows


def margins(
    rows: _build.BlockRows,  # the q blocks' rows, on w's device
    q: int,
    w: torch.Tensor,  # float32[d], the q blocks' w concatenated
    ids: torch.Tensor | None,  # int64[R] sampled rows, or None
    n_rows: int,  # R: len(ids), or every row N
    parts: torch.Tensor | None = None,  # float32[q, R], written if given
    gathered: StepRows | None = None,  # written if given (with ids)
) -> torch.Tensor:  # float32[R]
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``: one launch
    for the q blocks.  Raises on a CPU tensor, another dtype, a shape
    mismatch or a non-contiguous tensor.  The row ids must lie in ``[0,
    N)`` and ``rows`` must come from live tensors (the kernel checks
    neither)."""
    global launches
    if not w.is_cuda:
        raise ValueError("sparse_margin: the CUDA kernel needs CUDA tensors")
    dev = w.device
    _build.require_tensor("sparse_margin", "w", w, torch.float32, dev, (None,))
    if ids is not None:
        _build.require_tensor("sparse_margin", "ids", ids, torch.int64, dev, (n_rows,))
    if parts is not None:
        _build.require_tensor("sparse_margin", "parts", parts, torch.float32, dev, (q, n_rows))
    if gathered is not None:
        total = n_rows * sum(rows.nnz[:q])
        _build.require_tensor("sparse_margin", "gathered indices", gathered.indices,
                              torch.int32, dev, (total,))
        _build.require_tensor("sparse_margin", "gathered values", gathered.values,
                              torch.float32, dev, (total,))
    s = torch.empty((n_rows,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_sparse_margin(
            ctypes.addressof(rows), q, w.data_ptr(), None if ids is None else ids.data_ptr(),
            n_rows, s.data_ptr(), None if parts is None else parts.data_ptr(),
            None if gathered is None else gathered.indices.data_ptr(),
            None if gathered is None else gathered.values.data_ptr(), stream,
        )
    _build.check(rc, "sparse_margin")
    launches += 1
    return s


def sparse_margin(
    indices: torch.Tensor,  # int32[R, nnz_l], block-LOCAL ids in [0, d_block)
    values: torch.Tensor,  # float32[R, nnz_l]
    w_block: torch.Tensor,  # float32[d_block]
) -> torch.Tensor:  # float32[R]
    """One block's margins through the kernel: the q = 1 case, every row.

    Raises on anything the kernel does not take: a CPU tensor, another
    dtype, a shape mismatch or a non-contiguous tensor.  Ids must lie in
    ``[0, d_block)`` (a BlockCSR guarantees it; the kernel does not check).
    """
    if not w_block.is_cuda:
        raise ValueError("sparse_margin: the CUDA kernel needs CUDA tensors")
    _build.require_tensor("sparse_margin", "w_block", w_block, torch.float32,
                          w_block.device, (None,))
    rows = _build.block_rows("sparse_margin", (indices,), (values,), w_block.shape,
                             w_block.device)
    return margins(rows, 1, w_block, None, indices.shape[0])
