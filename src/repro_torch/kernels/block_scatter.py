"""block_scatter: the snapshot's block-local scatter, in flat order on the card.

    z[id] = sum over flat positions p with idx[p] = id, in increasing p,
            of values[p] * coeffs[p // nnz_l]

over one block's padded rows ``idx``/``values [N, nnz_l]`` and the
per-row coefficients ``coeffs [N]`` (float32): ``local_scatter``'s
function (``data/block_csr.py``).  The port's own kernel
(``csrc/block_scatter.cu``): the reference scatters with a plain
``.at[].add``, which has no Pallas kernel.  It replaces ``index_add_`` on
the card, whose float atomics add an id's terms in an order that changes
from run to run; the kernel adds them in flat order from +0.0, as the
CPU's ``index_add_`` and the reference's ``.at[].add`` do, so the three
agree bit for bit.

The order comes from a :class:`ScatterIndex`, built once per layout by
:func:`scatter_index` (``BlockCSR.scatter_index`` caches it), never per
snapshot: ``perm`` lists the flat positions of the nonzero entries grouped
by id (a stable sort, so increasing within an id), ``starts [dim + 1]``
bounds each id's run, and ``heavy`` lists the ids with more than
:data:`HEAVY_MIN` terms, longest first; the kernel gives each of those a
block of its own.  Stored zeros (the padding) are left out: their terms
are +-0.0 and adding them changes no bit.  Beside the kernel is
:func:`block_scatter_plain`, ``index_add_`` in flat order (the CPU path;
on the card, the atomics the kernel replaces).  ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

HEAVY_MIN = 1024  # ids with more terms than this get a block of their own


class ScatterIndex(NamedTuple):
    perm: torch.Tensor  # int32[E]: flat positions of the nonzero entries, grouped by id
    starts: torch.Tensor  # int32[dim + 1]: id's terms are perm[starts[id]:starts[id + 1]]
    heavy: torch.Tensor  # int32[H]: ids with more than HEAVY_MIN terms, longest first


def scatter_index(indices: torch.Tensor, values: torch.Tensor, block_dim: int) -> ScatterIndex:
    """The flat-order index of one block's rows, on their device."""
    if indices.numel() >= 2**31:
        raise ValueError(f"block_scatter: {indices.numel()} flat positions do not fit int32")
    dev = indices.device
    pos = torch.nonzero(values.reshape(-1) != 0).reshape(-1)
    ids = indices.reshape(-1)[pos].long()
    order = torch.sort(ids, stable=True).indices
    counts = torch.bincount(ids, minlength=block_dim)
    starts = torch.zeros(block_dim + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=starts[1:])
    heavy = torch.nonzero(counts > HEAVY_MIN).reshape(-1)
    heavy = heavy[torch.argsort(counts[heavy], descending=True, stable=True)]
    return ScatterIndex(pos[order].int(), starts.int(), heavy.int())


def block_scatter_plain(
    indices: torch.Tensor, values: torch.Tensor, coeffs: torch.Tensor, block_dim: int
) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` of the flat products."""
    flat_val = (values * coeffs[..., None]).reshape(-1)
    out = torch.zeros((block_dim,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, indices.reshape(-1), flat_val)


def block_scatter(
    values: torch.Tensor,  # float32[N, nnz_l]
    coeffs: torch.Tensor,  # float32[N]
    index: ScatterIndex,  # scatter_index() of these rows, on the same device
) -> torch.Tensor:  # float32[dim]
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape mismatch or a
    non-contiguous tensor.  The index must come from these rows (the
    kernel trusts its positions and ids).
    """
    global launches
    if not values.is_cuda:
        raise ValueError("block_scatter: the CUDA kernel needs CUDA tensors")
    dev = values.device
    _build.require_tensor("block_scatter", "values", values, torch.float32, dev, (None, None))
    rows, nnz = values.shape
    _build.require_tensor("block_scatter", "coeffs", coeffs, torch.float32, dev, (rows,))
    for name in ScatterIndex._fields:
        _build.require_tensor("block_scatter", name, getattr(index, name), torch.int32, dev,
                              (None,))
    dim = index.starts.shape[0] - 1
    if nnz < 1 or dim < 1 or rows * nnz >= 2**31:
        raise ValueError(f"block_scatter: rows [{rows}, {nnz}] over {dim} ids not taken")
    z = torch.empty((dim,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_block_scatter(
            values.data_ptr(), coeffs.data_ptr(), index.perm.data_ptr(),
            index.starts.data_ptr(), index.heavy.data_ptr(), z.data_ptr(), nnz, dim,
            index.heavy.shape[0], HEAVY_MIN, stream,
        )
    _build.check(rc, "block_scatter")
    launches += 1
    return z
