"""Padded-CSR sparse matrices for high-dimensional (d >> N) data.

Port of ``repro.data.sparse``.  Each instance is stored with a fixed nnz
budget:

    indices: int32[N, nnz_max]   feature ids, padded with 0
    values:  float32[N, nnz_max] feature values, padded with 0.0

Padding with (index 0, value 0.0) is safe for every operation here (dots
and scatter-adds), because a zero value contributes nothing.  The
feature-distributed view of the same matrix is
:class:`repro_torch.data.block_csr.BlockCSR`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PaddedCSR:
    """A sparse d x N design matrix stored instance-major with padded rows."""

    indices: torch.Tensor  # int32[N, nnz_max]
    values: torch.Tensor  # float32[N, nnz_max]
    labels: torch.Tensor  # float32[N], in {-1, +1}
    dim: int  # d

    @property
    def num_instances(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nnz_max(self) -> int:
        return int(self.indices.shape[1])

    def nnz_total(self) -> int:
        return int(torch.count_nonzero(self.values))

    def instance(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.indices[i], self.values[i]

    def to_dense(self) -> np.ndarray:
        """Dense d x N matrix (tests / tiny data only)."""
        n, nnz = self.indices.shape
        out = np.zeros((self.dim, n), dtype=np.float32)
        idx = self.indices.cpu().numpy().reshape(-1)
        val = self.values.cpu().numpy().astype(np.float32).reshape(-1)
        cols = np.repeat(np.arange(n), nnz)
        np.add.at(out, (idx, cols), val)
        return out


def margins_rows(
    indices: torch.Tensor, values: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """s_i = w^T x_i from padded rows (global ids)."""
    return torch.sum(w[indices] * values, dim=-1)


def margins(data: PaddedCSR, w: torch.Tensor) -> torch.Tensor:
    """s_i = w^T x_i for all instances; w is the dense d-vector."""
    return margins_rows(data.indices, data.values, w)


def scatter_grad(
    indices: torch.Tensor,
    values: torch.Tensor,
    coeffs: torch.Tensor,
    dim: int,
) -> torch.Tensor:
    """sum_i coeffs_i * x_i as a dense d-vector (the data-dependent gradient).

    indices/values: [N, nnz]; coeffs: [N].  On the CPU ``index_add_``
    accumulates in flat order, the reference's ``.at[].add`` order; on a
    CUDA tensor it accumulates with atomics, in an order that can change
    from run to run.
    """
    flat_idx = indices.reshape(-1)
    flat_val = (values * coeffs[:, None]).reshape(-1)
    out = torch.zeros((dim,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, flat_idx, flat_val)
