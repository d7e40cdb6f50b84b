"""block_scatter: the snapshot's scatter over all q blocks, in flat order on the card.

    z[b_l + id] = sum over flat positions p with idx_l[p] = id, in increasing p,
                  of values_l[p] * coeffs[p // nnz_l]

for every block l's padded rows ``idx_l``/``values_l [N, nnz_l]`` (local
ids, block l owning the global ids ``[b_l, b_{l+1})``) and the shared
per-row coefficients ``coeffs [N]`` (float32): ``local_scatter``'s
function (``data/block_csr.py``) of each block, concatenated.  The port's
own kernel (``csrc/block_scatter.cu``): the reference scatters with a
plain ``.at[].add``, which has no Pallas kernel.  It replaces
``index_add_`` on the card, whose float atomics add an id's terms in an
order that changes from run to run; the kernel adds them in flat order
from +0.0, as the CPU's ``index_add_`` and the reference's ``.at[].add``
do, so the three agree bit for bit.  One launch covers a whole snapshot,
so a snapshot costs its longest chain of dependent adds, not the sum of
each block's longest.

The order comes from a :class:`ScatterIndex`, built once per layout by
:func:`snapshot_index` (``BlockCSR.snapshot_index`` caches it per device;
:func:`scatter_index` is the one-block case), never per snapshot:
``perm`` lists each block's flat positions of the nonzero entries grouped
by global id (a stable sort, so increasing within an id), ``starts [d +
1]`` (int64) bounds each id's run, and ``heavy`` lists the ids with more
than ``heavy_min`` terms across all blocks, longest first; the kernel
gives each of those a block of its own and leaves them to it by the same
``heavy_min``, which the index carries.  Stored zeros (the padding) are
left out: their terms are +-0.0 and adding them changes no bit.  The
index holds no pointers, so the copies of a layout share it; the launch
passes the rows' pointers and widths by value.  Beside the kernel is
:func:`block_scatter_plain`, ``index_add_`` in flat order (the CPU path;
on the card, the atomics the kernel replaces).  ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import _build

launches = 0

HEAVY_MIN = 1024  # the default heavy_min: ids with more terms get a block of their own
MAX_BLOCKS = 128  # the kernel's kMaxBlocks: blocks one launch takes


class ScatterIndex(NamedTuple):
    perm: torch.Tensor  # int32[E]: each block's flat positions of its nonzero entries, by global id
    starts: torch.Tensor  # int64[d + 1]: id's terms are perm[starts[id]:starts[id + 1]]
    heavy: torch.Tensor  # int32[H]: global ids with more than heavy_min terms, longest first
    bounds: torch.Tensor  # int32[q + 1]: block l owns the ids [bounds[l], bounds[l + 1])
    shapes: tuple[tuple[int, int], ...]  # (N, nnz_l) of each block's rows
    heavy_min: int  # the threshold ``heavy`` was listed by; the launch passes it on


def snapshot_index(
    indices: Sequence[torch.Tensor],  # per block: int32[N, nnz_l], local ids
    values: Sequence[torch.Tensor],  # per block: float32[N, nnz_l]
    block_dims: Sequence[int],
    heavy_min: int = HEAVY_MIN,
) -> ScatterIndex:
    """The flat-order index of q blocks' rows, on their device."""
    if heavy_min < 1:
        raise ValueError(f"block_scatter: heavy_min {heavy_min} must be >= 1")
    dev = values[0].device
    positions, ids, shapes = [], [], []
    lo = 0
    for idx, val, dim in zip(indices, values, block_dims, strict=True):
        if idx.numel() >= 2**31:
            raise ValueError(f"block_scatter: {idx.numel()} flat positions do not fit int32")
        pos = torch.nonzero(val.reshape(-1) != 0).reshape(-1)
        positions.append(pos)
        ids.append(idx.reshape(-1)[pos].long() + lo)
        shapes.append(tuple(int(s) for s in val.shape))
        lo += int(dim)
    pos, gid = torch.cat(positions), torch.cat(ids)
    order = torch.sort(gid, stable=True).indices  # by id; blocks hold disjoint ids
    counts = torch.bincount(gid, minlength=lo)
    starts = torch.zeros(lo + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=starts[1:])
    heavy = torch.nonzero(counts > heavy_min).reshape(-1)
    heavy = heavy[torch.argsort(counts[heavy], descending=True, stable=True)]
    edges = [0]
    for dim in block_dims:
        edges.append(edges[-1] + int(dim))
    bounds = torch.tensor(edges, dtype=torch.int32).to(dev)
    return ScatterIndex(pos[order].int(), starts, heavy.int(), bounds, tuple(shapes),
                        int(heavy_min))


def scatter_index(
    indices: torch.Tensor, values: torch.Tensor, block_dim: int, heavy_min: int = HEAVY_MIN
) -> ScatterIndex:
    """The flat-order index of one block's rows: the q = 1 case."""
    return snapshot_index((indices,), (values,), (block_dim,), heavy_min)


def block_scatter_plain(
    indices: torch.Tensor, values: torch.Tensor, coeffs: torch.Tensor, block_dim: int
) -> torch.Tensor:
    """The plain PyTorch version of one block: ``index_add_`` of the flat
    products."""
    flat_val = (values * coeffs[..., None]).reshape(-1)
    out = torch.zeros((block_dim,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, indices.reshape(-1), flat_val)


def block_scatter(
    values: torch.Tensor | Sequence[torch.Tensor],  # float32[N, nnz_l], or one per block
    coeffs: torch.Tensor,  # float32[N]
    index: ScatterIndex,  # the index of these rows, on the same device
    timing: torch.Tensor | None = None,  # int64[2H]: each heavy fold's start and end (ns)
) -> torch.Tensor:  # float32[d]
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``: one launch
    for all the blocks ``index`` covers.

    Raises on a CPU tensor, another dtype, a shape mismatch or a
    non-contiguous tensor.  The index must come from these rows (the
    kernel trusts its positions and ids).
    """
    global launches
    blocks = (values,) if isinstance(values, torch.Tensor) else tuple(values)
    if not blocks or not all(v.is_cuda for v in blocks):
        raise ValueError("block_scatter: the CUDA kernel needs CUDA tensors")
    dev = blocks[0].device
    if len(blocks) != len(index.shapes):
        raise ValueError(f"block_scatter: {len(blocks)} blocks for an index of "
                         f"{len(index.shapes)}")
    if len(blocks) > MAX_BLOCKS:
        raise ValueError(f"block_scatter: {len(blocks)} blocks, one launch takes {MAX_BLOCKS}")
    for l, (val, shape) in enumerate(zip(blocks, index.shapes)):
        _build.require_tensor("block_scatter", f"values[{l}]", val, torch.float32, dev, shape)
        rows, nnz = shape
        if nnz < 1 or rows * nnz >= 2**31:
            raise ValueError(f"block_scatter: rows [{rows}, {nnz}] of block {l} not taken")
    rows = index.shapes[0][0]
    if any(shape[0] != rows for shape in index.shapes):
        raise ValueError(f"block_scatter: the blocks' row counts differ: {index.shapes}")
    _build.require_tensor("block_scatter", "coeffs", coeffs, torch.float32, dev, (rows,))
    q, dim = len(blocks), index.starts.shape[0] - 1
    for name, dtype, shape in (("perm", torch.int32, (None,)), ("starts", torch.int64, (dim + 1,)),
                               ("heavy", torch.int32, (None,)), ("bounds", torch.int32, (q + 1,))):
        _build.require_tensor("block_scatter", name, getattr(index, name), dtype, dev, shape)
    if dim < 1:
        raise ValueError("block_scatter: an index over no ids")
    n_heavy = index.heavy.shape[0]
    if timing is not None:
        _build.require_tensor("block_scatter", "timing", timing, torch.int64, dev, (2 * n_heavy,))
    pointers = (ctypes.c_void_p * q)(*(v.data_ptr() for v in blocks))
    widths = (ctypes.c_int * q)(*(shape[1] for shape in index.shapes))
    z = torch.empty((dim,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_block_scatter(
            pointers, widths, index.bounds.data_ptr(), q, coeffs.data_ptr(),
            index.perm.data_ptr(), index.starts.data_ptr(), index.heavy.data_ptr(), n_heavy,
            index.heavy_min, z.data_ptr(), dim,
            None if timing is None else timing.data_ptr(), stream,
        )
    _build.check(rc, "block_scatter")
    launches += 1
    return z
