"""Block-local sharded CSR: the feature-distributed layout of a PaddedCSR.

Port of ``repro.data.block_csr``.  For each feature block l of a
:class:`~repro_torch.core.partition.FeaturePartition` the entries of
every instance are stored as padded rows with a per-block nnz budget:

    indices[l]: int32[N, nnz_l]   LOCAL feature ids in [0, dim_l), pad 0
    values[l]:  float[N, nnz_l]   matching values, pad 0.0

so worker l gathers against its local dense ``w`` block with no masking
arithmetic.  Padding (local id 0, value 0.0) is inert in dots and
scatter-adds.  Entry order within a row is preserved from the source.

:func:`local_margins` / :func:`local_scatter` are the plain block-local
hot paths; the kernels of :mod:`repro_torch.kernels` compute the same
functions on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import FeaturePartition
from repro_torch.data.sparse import PaddedCSR
from repro_torch.kernels import _build
from repro_torch.kernels.block_scatter import ScatterIndex, snapshot_index


@dataclasses.dataclass(frozen=True)
class BlockCSR:
    """A PaddedCSR re-indexed into q block-local shards."""

    partition: FeaturePartition
    indices: tuple[torch.Tensor, ...]  # per block: int32[N, nnz_l], local ids
    values: tuple[torch.Tensor, ...]  # per block: float[N, nnz_l]
    labels: torch.Tensor  # float[N], in {-1, +1}
    dim: int  # global d
    # Per-block int32[dim_l] counts of rows storing a nonzero value at
    # each local id (None: compute on demand with nnz_col_block).
    nnz_col: tuple[torch.Tensor, ...] | None = None
    # The source's global padded-row width, which the cost model charges
    # against (None: fall back to the sum of per-block budgets).
    nnz_max: int | None = None
    # snapshot_index's cache, keyed by device; shared by the copies that
    # .to() and dataclasses.replace make, which keep the rows (an index
    # holds no pointers).
    _snapshot_index: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )
    # block_rows' cache, keyed by device.  It holds the rows' raw pointers,
    # so every copy starts its own (init=False: replace and .to() do not
    # pass it on).
    _block_rows: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )

    @property
    def num_blocks(self) -> int:
        return self.partition.num_blocks

    @property
    def num_instances(self) -> int:
        return int(self.indices[0].shape[0])

    @property
    def block_dims(self) -> tuple[int, ...]:
        return tuple(self.partition.block_sizes())

    @property
    def nnz_budgets(self) -> tuple[int, ...]:
        return tuple(int(i.shape[1]) for i in self.indices)

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def block(self, l: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.indices[l], self.values[l]

    def global_nnz_max(self) -> int:
        """The global padded-row width the cost model charges against."""
        if self.nnz_max is not None:
            return self.nnz_max
        return int(sum(self.nnz_budgets))

    def nnz_col_block(self, l: int) -> torch.Tensor:
        """int32[dim_l] per-feature instance counts for block ``l``."""
        if self.nnz_col is not None:
            return self.nnz_col[l]
        counts = _count_cols(
            self.indices[l].cpu().numpy(),
            self.values[l].cpu().numpy(),
            int(self.block_dims[l]),
        )
        return torch.from_numpy(counts).to(self.device)

    def snapshot_index(self) -> ScatterIndex:
        """The flat-order index of all q blocks for the snapshot scatter
        kernel (one launch a snapshot), built at first use on the rows'
        device and kept."""
        key = str(self.values[0].device)
        if key not in self._snapshot_index:
            self._snapshot_index[key] = snapshot_index(
                self.indices, self.values, self.block_dims
            )
        return self._snapshot_index[key]

    def block_rows(self) -> _build.BlockRows:
        """The q blocks' rows as the margins and catch-up kernels take them
        by value (one launch a step for all q blocks), built at first use
        on a CUDA device and kept: a step then costs one ctypes call."""
        key = str(self.values[0].device)
        if key not in self._block_rows:
            self._block_rows[key] = _build.block_rows(
                "BlockCSR.block_rows", self.indices, self.values, self.block_dims,
                self.values[0].device,
            )
        return self._block_rows[key]

    def to(self, device: torch.device | str) -> "BlockCSR":
        """The same layout with every tensor on ``device``: ``self`` when
        they all lie there already, so its ``block_rows`` table is kept."""
        device = torch.device(device)
        tensors = (*self.indices, *self.values, self.labels, *(self.nnz_col or ()))
        if all(_same_device(t.device, device) for t in tensors):
            return self
        return dataclasses.replace(
            self,
            indices=tuple(i.to(device) for i in self.indices),
            values=tuple(v.to(device) for v in self.values),
            labels=self.labels.to(device),
            nnz_col=(
                None if self.nnz_col is None
                else tuple(c.to(device) for c in self.nnz_col)
            ),
        )

    @classmethod
    def from_padded(
        cls,
        data: PaddedCSR,
        partition: FeaturePartition,
        *,
        lane_multiple: int = 1,
    ) -> "BlockCSR":
        """Build the block-local layout (host numpy, once per data set).

        Byte-identical to the reference's ``BlockCSR.from_padded``:
        ``lane_multiple`` rounds each block's budget up; the single-block
        partition reuses the PaddedCSR rows as they are; entries with
        ``value == 0.0`` are dropped during re-indexing (an explicit zero
        becomes padding, which no operation here can tell apart).  The
        result's tensors lie on the CPU; move them with :meth:`to`.
        """
        if partition.dim != data.dim:
            raise ValueError(
                f"partition covers dim={partition.dim}, data has dim={data.dim}"
            )
        idx = data.indices.cpu().numpy()
        val = data.values.cpu().numpy()
        labels = data.labels.cpu()
        if partition.num_blocks == 1:
            return cls(
                partition=partition,
                indices=(data.indices.cpu(),),
                values=(data.values.cpu(),),
                labels=labels,
                dim=data.dim,
                nnz_col=(torch.from_numpy(_count_cols(idx, val, data.dim)),),
                nnz_max=data.nnz_max,
            )
        blocks = [
            _block_arrays(idx, val, *partition.block(l), lane_multiple)
            for l in range(partition.num_blocks)
        ]
        return cls(
            partition=partition,
            indices=tuple(b[0] for b in blocks),
            values=tuple(b[1] for b in blocks),
            labels=labels,
            dim=data.dim,
            nnz_col=tuple(b[2] for b in blocks),
            nnz_max=data.nnz_max,
        )

    @classmethod
    def block_of(
        cls,
        data: PaddedCSR,
        partition: FeaturePartition,
        l: int,
    ) -> "BlockCSR":
        """``from_padded(data, partition).one_block(l)``, the same bytes,
        without building the other blocks: what the rank that owns block
        ``l`` builds for itself in the multi-device driver."""
        if partition.dim != data.dim:
            raise ValueError(
                f"partition covers dim={partition.dim}, data has dim={data.dim}"
            )
        if partition.num_blocks == 1:  # the PaddedCSR rows as they are
            return cls.from_padded(data, partition).one_block(l)
        lo, hi = partition.block(l)
        idx, val, nnz_col = _block_arrays(
            data.indices.cpu().numpy(), data.values.cpu().numpy(), lo, hi, lane_multiple=1
        )
        return cls(
            partition=FeaturePartition(dim=hi - lo, bounds=(0, hi - lo)),
            indices=(idx,),
            values=(val,),
            labels=data.labels.cpu(),
            dim=hi - lo,
            nnz_col=(nnz_col,),
            nnz_max=data.nnz_max,
        )

    def one_block(self, l: int) -> "BlockCSR":
        """Block ``l`` alone, as a one-block layout over its own features
        (local ids, its own width ``nnz_l``, every label): what the rank
        that owns block ``l`` holds in the multi-device driver.  The same
        tensors, no copy; the cost model's global row width is kept."""
        lo, hi = self.partition.block(l)
        return BlockCSR(
            partition=FeaturePartition(dim=hi - lo, bounds=(0, hi - lo)),
            indices=(self.indices[l],),
            values=(self.values[l],),
            labels=self.labels,
            dim=hi - lo,
            nnz_col=None if self.nnz_col is None else (self.nnz_col[l],),
            nnz_max=self.global_nnz_max(),
        )

    def stacked(self, budget: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Uniform-budget [q, N, B] index/value stacks: every block padded
        (local id 0, value 0.0) up to a common nnz budget (default: the
        largest per-block budget), for callers that shard one tensor's
        leading axis over the ranks."""
        common = max(self.nnz_budgets)
        if budget is not None:
            if budget < common:
                raise ValueError(f"budget {budget} < required {common}")
            common = budget
        pad = torch.nn.functional.pad
        idx = torch.stack([pad(i, (0, common - i.shape[1])) for i in self.indices])
        val = torch.stack([pad(v, (0, common - v.shape[1])) for v in self.values])
        return idx, val

    def nnz_total(self) -> int:
        return int(sum(int(torch.count_nonzero(v)) for v in self.values))


def _same_device(have: torch.device, want: torch.device) -> bool:
    """``have`` is ``want``, reading a bare ``cuda`` as the current card."""
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    return have == want


def _block_arrays(
    idx: np.ndarray, val: np.ndarray, lo: int, hi: int, lane_multiple: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows of features [lo, hi) in local ids, compacted to the block's own
    budget (rounded up to ``lane_multiple``), and its per-feature counts."""
    n = idx.shape[0]
    in_blk = (idx >= lo) & (idx < hi) & (val != 0.0)
    counts = in_blk.sum(axis=1)
    budget = max(1, int(counts.max()) if n else 1)
    budget += (-budget) % lane_multiple
    out_idx = np.zeros((n, budget), dtype=np.int32)
    out_val = np.zeros((n, budget), dtype=val.dtype)
    rows, cols = np.nonzero(in_blk)  # row-major: preserves row order
    # position of each entry within its (compacted) row
    pos = np.arange(rows.size) - np.searchsorted(rows, rows, side="left")
    out_idx[rows, pos] = idx[rows, cols] - lo
    out_val[rows, pos] = val[rows, cols]
    return (
        torch.from_numpy(out_idx),
        torch.from_numpy(out_val),
        torch.from_numpy(_count_cols(out_idx, out_val, hi - lo)),
    )


def _count_cols(indices: np.ndarray, values: np.ndarray, dim: int) -> np.ndarray:
    """int32[dim] count of rows storing a nonzero value per local id."""
    mask = values != 0.0
    return np.bincount(
        indices[mask].reshape(-1), minlength=dim
    ).astype(np.int32)


def aot_nnz_budget(nnz_max: int, q: int) -> int:
    """Stacked-layout nnz budget for shape-only (dry-run / perf) shapes.

    The runtime budget is data-dependent (``BlockCSR.stacked``); for
    shapes without data we model nnz_max/q with 4x slack for skewed text
    feature popularity, never below one lane octet.  Keep in lockstep
    with what ``run_fdsvrg_sharded`` feeds the step.
    """
    return max(8, -(-nnz_max // q) * 4)


def local_margins(
    indices: torch.Tensor, values: torch.Tensor, w_block: torch.Tensor
) -> torch.Tensor:
    """s^(l)_i = w^(l)T x^(l)_i from block-LOCAL padded rows ([R, nnz_l]).

    A ``[dim_l, k]`` block (k outputs) gives ``[R, k]`` margins, column
    by column the 1-D case (the reference vmaps it over the outputs): each
    output's rows are summed along a contiguous last axis, as there.
    """
    if w_block.dim() == 2:
        return torch.sum(w_block.t()[:, indices] * values, dim=-1).t()
    return torch.sum(w_block[indices] * values, dim=-1)


def local_scatter(
    indices: torch.Tensor,
    values: torch.Tensor,
    coeffs: torch.Tensor,
    block_dim: int,
) -> torch.Tensor:
    """sum_i coeffs_i * x^(l)_i as a dense block vector, local ids only.

    ``[R, k]`` coefficients (k outputs) give a ``[block_dim, k]`` block.
    On the CPU, ``index_add_`` accumulates in flat order and equals the
    reference's ``.at[].add`` bit for bit.
    """
    flat_idx = indices.reshape(-1)
    if coeffs.dim() == values.dim():
        k = coeffs.shape[-1]
        flat_val = (values[..., None] * coeffs[:, None, :]).reshape(-1, k)
        out = torch.zeros((block_dim, k), dtype=values.dtype, device=values.device)
        return out.index_add_(0, flat_idx, flat_val)
    flat_val = (values * coeffs[..., None]).reshape(-1)
    out = torch.zeros((block_dim,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, flat_idx, flat_val)
