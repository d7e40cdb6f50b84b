"""Carry state across from the reference: numpy arrays -> the port's objects.

The JAX package's arrays go through ``numpy.asarray`` on the caller's
side; these functions build the port's :class:`PaddedCSR`,
:class:`BlockCSR`, initial ``w`` and dense problem from them, checking what the port's
kernels take on trust (dtypes, shapes, ids inside their block).  The
tests use them to feed both packages identical bytes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.partition import FeaturePartition
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.sparse import PaddedCSR


def _tensor(a: np.ndarray, dtype: np.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != dtype:
        raise TypeError(f"expected {dtype} array, got {a.dtype}")
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def padded_csr(
    indices: np.ndarray, values: np.ndarray, labels: np.ndarray, dim: int
) -> PaddedCSR:
    """A :class:`PaddedCSR` from int32 ids, float32 values and labels."""
    idx = _tensor(indices, np.int32)
    val = _tensor(values, np.float32)
    if idx.shape != val.shape or idx.dim() != 2:
        raise ValueError(f"indices {tuple(idx.shape)} vs values {tuple(val.shape)}")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= dim):
        raise ValueError(f"feature ids must lie in [0, {dim})")
    return PaddedCSR(
        indices=idx, values=val, labels=_tensor(labels, np.float32), dim=int(dim)
    )


def block_csr(
    indices: Sequence[np.ndarray],
    values: Sequence[np.ndarray],
    labels: np.ndarray,
    bounds: Sequence[int],
    dim: int,
    nnz_max: int | None = None,
    nnz_col: Sequence[np.ndarray] | None = None,
) -> BlockCSR:
    """A :class:`BlockCSR` from per-block local ids/values and the bounds."""
    partition = FeaturePartition(dim=int(dim), bounds=tuple(int(b) for b in bounds))
    if len(indices) != partition.num_blocks or len(values) != partition.num_blocks:
        raise ValueError("one indices/values array per block required")
    idx = tuple(_tensor(i, np.int32) for i in indices)
    val = tuple(_tensor(v, np.float32) for v in values)
    for l, (i, v) in enumerate(zip(idx, val)):
        d_l = partition.block_sizes()[l]
        if i.shape != v.shape or i.dim() != 2:
            raise ValueError(f"block {l}: indices {tuple(i.shape)} vs values {tuple(v.shape)}")
        if i.numel() and (int(i.min()) < 0 or int(i.max()) >= d_l):
            raise ValueError(f"block {l}: local ids must lie in [0, {d_l})")
    cols = None
    if nnz_col is not None:
        cols = tuple(_tensor(c, np.int32) for c in nnz_col)
    return BlockCSR(
        partition=partition,
        indices=idx,
        values=val,
        labels=_tensor(labels, np.float32),
        dim=int(dim),
        nnz_col=cols,
        nnz_max=nnz_max,
    )


def init_w(w: np.ndarray) -> torch.Tensor:
    """An initial iterate (float32 [d]) from a reference array."""
    t = _tensor(w, np.float32)
    if t.dim() != 1:
        raise ValueError(f"w must be 1-D, got shape {tuple(t.shape)}")
    return t


def dense_problem(
    D: np.ndarray, y: np.ndarray, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense layout's data ``D [d, N]`` and labels ``y [N]`` on ``device``.

    Float32 arrays, as ``make_dense_classification`` makes them; ``D``
    comes back contiguous, the layout ``ops.margins_dense`` takes.
    """
    data = _tensor(D, np.float32)
    labels = _tensor(y, np.float32)
    if data.dim() != 2 or labels.shape != (data.shape[1],):
        raise ValueError(f"D {tuple(data.shape)} vs y {tuple(labels.shape)}: want [d, N] and [N]")
    return data.contiguous().to(device), labels.to(device)
