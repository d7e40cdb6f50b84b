"""Streaming sparse ingestion: ``DataSource`` -> per-worker ``BlockCSR``.

Port of ``repro.data.pipeline`` (host NumPy; the sources and builders
are copied, not imported).  The paper's argument is the d >> N regime,
where no node holds the full design matrix, so this module builds each
worker's slab without the global padded arrays:

* :class:`DataSource` — one protocol over where rows come from: an
  in-memory :class:`~repro_torch.data.sparse.PaddedCSR`
  (:class:`ArraySource`), the synthetic generator
  (:class:`SyntheticSource`) or a LibSVM file (:class:`LibSVMSource`).
  A source yields bounded :class:`RowChunk`\\ s, knows its
  :class:`SourceStats` up front, and has a content ``digest()`` that
  keys the on-disk slab cache (:mod:`repro_torch.data.ingest_cache`).
  The digest is the reference's hex string for the same rows.
* :func:`stream_block_csr` — worker l's slab built chunk by chunk from
  only the features in ``[lo_l, hi_l)`` (plus the ``nnz_col`` counts the
  lazy proba kernels need); :func:`stream_block_slab` builds one worker's
  slab alone.  Both are byte for byte ``BlockCSR.from_padded`` of the
  materialized rows, for every chunk size, q and lane multiple.  The
  result's tensors lie on the CPU; its device caches start empty.
* :func:`streamed_margins` — ``w^T x_i`` for every row, a chunk at a
  time, on the card through the margin kernel (kernel 1, the one-block
  launch over the chunk's global ids against the whole ``w``).
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import os
from typing import Iterator

import numpy as np
import torch

from repro_torch.data import libsvm as libsvm_lib
from repro_torch.data.block_csr import BlockCSR, _count_cols
from repro_torch.data.sparse import PaddedCSR

#: Default rows-per-chunk budget; at news20-like widths (~500 stored
#: entries a row, 8 bytes each) this holds host memory near 256 MiB.
DEFAULT_CHUNK_ROWS = 65536


@dataclasses.dataclass(frozen=True)
class SourceStats:
    """What a source knows about itself before any slab is built."""

    num_instances: int
    dim: int
    nnz_max: int  # global padded-row width (>= 1 for parsed text sources)
    nnz_total: int


@dataclasses.dataclass(frozen=True)
class RowChunk:
    """A bounded slice of rows in the padded layout (NumPy arrays):
    entries left-aligned in source order, padded with ``(0, 0.0)``;
    ``labels`` already canonical {-1, +1} in the values' float family."""

    indices: np.ndarray  # int32[c, w]
    values: np.ndarray  # float[c, w]
    labels: np.ndarray  # float[c]


class DataSource(abc.ABC):
    """Where rows come from.  Implementations are deterministic: the same
    source yields the same chunks every pass, and ``digest()`` changes iff
    the rows would."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def stats(self) -> SourceStats: ...

    @abc.abstractmethod
    def digest(self) -> str:
        """Content digest keying the on-disk slab cache."""

    @abc.abstractmethod
    def chunks(
        self, chunk_rows: int = DEFAULT_CHUNK_ROWS
    ) -> Iterator[RowChunk]: ...

    def materialize(self) -> PaddedCSR:
        """The global padded layout (CPU tensors): the allocation streaming
        exists to avoid, for the callers that need every row at once."""
        stats = self.stats()
        width = stats.nnz_max
        idx_parts, val_parts, lab_parts = [], [], []
        for chunk in self.chunks():
            pad = width - chunk.indices.shape[1]
            idx_parts.append(np.pad(chunk.indices, ((0, 0), (0, pad))))
            val_parts.append(np.pad(chunk.values, ((0, 0), (0, pad))))
            lab_parts.append(chunk.labels)
        return PaddedCSR(
            indices=torch.from_numpy(np.vstack(idx_parts)),
            values=torch.from_numpy(np.vstack(val_parts)),
            labels=torch.from_numpy(np.concatenate(lab_parts)),
            dim=stats.dim,
        )


def is_source(obj) -> bool:
    return isinstance(obj, DataSource)


def as_source(obj) -> DataSource:
    """Coerce a PaddedCSR, a LibSVM file path, or a DataSource."""
    if isinstance(obj, DataSource):
        return obj
    if isinstance(obj, PaddedCSR):
        return ArraySource(obj)
    if isinstance(obj, (str, os.PathLike)):
        return LibSVMSource(os.fspath(obj))
    raise TypeError(
        f"cannot build a DataSource from {type(obj).__name__}; pass a "
        "PaddedCSR, a LibSVM file path, or a DataSource"
    )


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


class ArraySource(DataSource):
    """An in-memory :class:`PaddedCSR`, chunked by row slices at its full
    padded width (so the q = 1 build reproduces the arrays as they are)."""

    def __init__(self, data: PaddedCSR, *, name: str = "array") -> None:
        self._data = data
        self._name = name
        self._digest: str | None = None
        self._arrays: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    @property
    def name(self) -> str:
        return self._name

    def _numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._arrays is None:
            self._arrays = tuple(
                np.asarray(t.cpu()) for t in
                (self._data.indices, self._data.values, self._data.labels)
            )
        return self._arrays

    def stats(self) -> SourceStats:
        values = self._numpy()[1]
        return SourceStats(
            num_instances=self._data.num_instances,
            dim=self._data.dim,
            nnz_max=self._data.nnz_max,
            nnz_total=int(np.count_nonzero(values)),
        )

    def digest(self) -> str:
        if self._digest is None:
            h = hashlib.sha256()
            h.update(f"array:v1:dim={self._data.dim}:".encode())
            for arr in self._numpy():
                a = np.ascontiguousarray(arr)
                h.update(str((a.dtype, a.shape)).encode())
                h.update(a.tobytes())
            self._digest = h.hexdigest()
        return self._digest

    def chunks(
        self, chunk_rows: int = DEFAULT_CHUNK_ROWS
    ) -> Iterator[RowChunk]:
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows >= 1 required, got {chunk_rows}")
        indices, values, labels = self._numpy()
        for lo in range(0, indices.shape[0], chunk_rows):
            hi = lo + chunk_rows
            yield RowChunk(indices[lo:hi], values[lo:hi], labels[lo:hi])

    def materialize(self) -> PaddedCSR:
        return self._data


class SyntheticSource(DataSource):
    """The synthetic generator behind a parametric digest: the digest is a
    function of the generation parameters, so a cache key never needs the
    data; the rows are generated once, on first access."""

    def __init__(
        self,
        *,
        dim: int,
        num_instances: int,
        nnz_per_instance: int,
        seed: int = 0,
        name: str = "synthetic",
    ) -> None:
        self._dim = dim
        self._n = num_instances
        self._nnz = nnz_per_instance
        self._seed = seed
        self._name = name
        self._generated: ArraySource | None = None

    @classmethod
    def from_dataset(
        cls, dataset: str, *, scaled: bool = True, seed: int = 0
    ) -> "SyntheticSource":
        from repro_torch.data import datasets

        spec = datasets.spec(dataset, scaled=scaled)
        return cls(
            dim=spec.dim,
            num_instances=spec.num_instances,
            nnz_per_instance=spec.nnz_per_instance,
            seed=seed,
            name=f"{dataset}{'' if scaled else '-full'}",
        )

    @property
    def name(self) -> str:
        return self._name

    def stats(self) -> SourceStats:
        # The generator emits exactly nnz_per_instance nonzero entries a row.
        return SourceStats(
            num_instances=self._n,
            dim=self._dim,
            nnz_max=self._nnz,
            nnz_total=self._n * self._nnz,
        )

    def digest(self) -> str:
        from repro_torch.data.synthetic import GENERATOR_VERSION

        return hashlib.sha256(
            f"synthetic:v{GENERATOR_VERSION}:dim={self._dim}:n={self._n}:"
            f"nnz={self._nnz}:seed={self._seed}".encode()
        ).hexdigest()

    def _array(self) -> ArraySource:
        if self._generated is None:
            from repro_torch.data.synthetic import make_sparse_classification

            self._generated = ArraySource(
                make_sparse_classification(
                    dim=self._dim,
                    num_instances=self._n,
                    nnz_per_instance=self._nnz,
                    seed=self._seed,
                ),
                name=self._name,
            )
        return self._generated

    def chunks(
        self, chunk_rows: int = DEFAULT_CHUNK_ROWS
    ) -> Iterator[RowChunk]:
        return self._array().chunks(chunk_rows)

    def materialize(self) -> PaddedCSR:
        return self._array().materialize()


class LibSVMSource(DataSource):
    """An on-disk LibSVM file, parsed in bounded chunks.

    The stats pass runs once per source object and fixes the label
    convention from the file's global label alphabet; ``dim`` defaults to
    ``max stored id + 1``.  ``digest()`` is the file content's sha256
    (hashing, not parsing, so a warm cache hit never tokenizes a line),
    kept against ``(size, mtime_ns)``.
    """

    def __init__(self, path: str, *, dim: int | None = None) -> None:
        self.path = os.fspath(path)
        self._dim_arg = dim
        self._stats: SourceStats | None = None
        self._mapper = None
        self._digest: tuple[tuple[int, int], str] | None = None

    @property
    def name(self) -> str:
        return os.path.basename(self.path)

    def _scan(self) -> SourceStats:
        if self._stats is None:
            scanned = libsvm_lib.scan_libsvm(self.path)
            if scanned.num_instances == 0:
                raise ValueError(f"{self.path}: no data rows")
            dim = max(scanned.max_index + 1, 1)
            if self._dim_arg is not None:
                if self._dim_arg <= scanned.max_index:
                    raise ValueError(
                        f"dim={self._dim_arg} but {self.path} stores feature "
                        f"id {scanned.max_index} (0-based)"
                    )
                dim = self._dim_arg
            self._mapper = libsvm_lib.canonical_label_map(scanned.label_values)
            self._stats = SourceStats(
                num_instances=scanned.num_instances,
                dim=dim,
                nnz_max=max(1, scanned.nnz_max),
                nnz_total=scanned.nnz_total,
            )
        return self._stats

    def stats(self) -> SourceStats:
        return self._scan()

    def digest(self) -> str:
        st = os.stat(self.path)
        key = (st.st_size, st.st_mtime_ns)
        if self._digest is None or self._digest[0] != key:
            h = hashlib.sha256()
            h.update(f"libsvm:v1:dim={self._dim_arg}:".encode())
            with open(self.path, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
            self._digest = (key, h.hexdigest())
        return self._digest[1]

    def chunks(
        self, chunk_rows: int = DEFAULT_CHUNK_ROWS
    ) -> Iterator[RowChunk]:
        self._scan()  # fixes the label convention before the first chunk
        for raw_labels, indices, values in libsvm_lib.iter_libsvm_chunks(
            self.path, chunk_rows
        ):
            yield RowChunk(indices, values, self._mapper(raw_labels))

    def materialize(self) -> PaddedCSR:
        stats = self._scan()
        return libsvm_lib.load_libsvm(self.path, dim=stats.dim)


# ---------------------------------------------------------------------------
# Incremental BlockCSR construction
# ---------------------------------------------------------------------------


class _RawAccumulator:
    """q = 1: keep rows as they are (``from_padded``'s single-block path:
    stored explicit zeros and padding survive untouched)."""

    def __init__(self, dim: int, width: int) -> None:
        self.dim = dim
        self.width = width
        self._idx: list[np.ndarray] = []
        self._val: list[np.ndarray] = []

    def add(self, idx: np.ndarray, val: np.ndarray) -> None:
        pad = self.width - idx.shape[1]
        if pad < 0:
            raise ValueError(
                f"chunk width {idx.shape[1]} exceeds the source's declared "
                f"nnz_max {self.width}"
            )
        self._idx.append(np.pad(idx, ((0, 0), (0, pad))))
        self._val.append(np.pad(val, ((0, 0), (0, pad))))

    def finalize(self, lane_multiple: int):
        del lane_multiple  # from_padded's q = 1 path keeps the width as is
        idx = np.vstack(self._idx) if self._idx else np.zeros((0, self.width), np.int32)
        val = np.vstack(self._val) if self._val else np.zeros((0, self.width), np.float32)
        return idx, val, _count_cols(idx, val, self.dim)


class _BlockAccumulator:
    """One feature block's compacted entries, chunk by chunk: the mask,
    the row-major compaction order, the budget rule and the ``nnz_col``
    counts of ``BlockCSR.from_padded``'s per-block pass, restricted to one
    chunk of rows at a time."""

    def __init__(self, lo: int, hi: int) -> None:
        self.lo = lo
        self.hi = hi
        self._strips: list[tuple[np.ndarray, np.ndarray]] = []
        self._rows = 0
        self._max_count = 0
        self._nnz_col = np.zeros(hi - lo, dtype=np.int64)

    def add(self, idx: np.ndarray, val: np.ndarray) -> None:
        in_blk = (idx >= self.lo) & (idx < self.hi) & (val != 0.0)
        counts = in_blk.sum(axis=1)
        c = idx.shape[0]
        w = int(counts.max()) if c else 0
        self._max_count = max(self._max_count, w)
        out_idx = np.zeros((c, w), dtype=np.int32)
        out_val = np.zeros((c, w), dtype=val.dtype)
        rows, cols = np.nonzero(in_blk)  # row-major: preserves row order
        pos = np.arange(rows.size) - np.searchsorted(rows, rows, side="left")
        out_idx[rows, pos] = idx[rows, cols] - self.lo
        out_val[rows, pos] = val[rows, cols]
        self._strips.append((out_idx, out_val))
        self._rows += c
        if rows.size:
            self._nnz_col += np.bincount(
                out_idx[rows, pos].astype(np.int64), minlength=self.hi - self.lo
            )

    def finalize(self, lane_multiple: int):
        budget = max(1, self._max_count)
        budget += (-budget) % lane_multiple
        dtype = self._strips[0][1].dtype if self._strips else np.float32
        indices = np.zeros((self._rows, budget), dtype=np.int32)
        values = np.zeros((self._rows, budget), dtype=dtype)
        row0 = 0
        for s_idx, s_val in self._strips:
            c, w = s_idx.shape
            if w:
                indices[row0 : row0 + c, :w] = s_idx
                values[row0 : row0 + c, :w] = s_val
            row0 += c
        return indices, values, self._nnz_col.astype(np.int32)


def _accumulators(partition, block_ids, width):
    out = {}
    for l in block_ids:
        if partition.num_blocks == 1:
            out[l] = _RawAccumulator(partition.dim, width)
        else:
            lo, hi = partition.block(l)
            out[l] = _BlockAccumulator(lo, hi)
    return out


def _check_dim(partition, stats: SourceStats) -> None:
    if partition.dim != stats.dim:
        raise ValueError(
            f"partition covers dim={partition.dim}, source has "
            f"dim={stats.dim}"
        )


def stream_block_csr(
    source: DataSource,
    partition,
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    lane_multiple: int = 1,
) -> BlockCSR:
    """Build the full per-worker :class:`BlockCSR` (CPU tensors) by
    streaming ``source``: byte for byte ``BlockCSR.from_padded(
    source.materialize(), partition, lane_multiple=...)`` for any
    ``chunk_rows``, without the global ``[N, nnz_max]`` arrays.  Peak host
    memory is one chunk plus the compacted slabs."""
    stats = source.stats()
    _check_dim(partition, stats)
    q = partition.num_blocks
    acc = _accumulators(partition, range(q), stats.nnz_max)
    labels_parts: list[np.ndarray] = []
    for chunk in source.chunks(chunk_rows):
        labels_parts.append(chunk.labels)
        for a in acc.values():
            a.add(chunk.indices, chunk.values)
    return _assemble(partition, acc, labels_parts, stats, lane_multiple, source)


def stream_block_slab(
    source: DataSource,
    partition,
    block_id: int,
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    lane_multiple: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One worker's ``(indices, values, nnz_col)`` slab as NumPy arrays:
    worker ``block_id`` parses the stream and keeps only its own
    ``[lo, hi)`` entries (O(nnz_l) memory; q parse passes for q workers,
    which the ingest cache amortizes to one)."""
    stats = source.stats()
    _check_dim(partition, stats)
    acc = _accumulators(partition, [block_id], stats.nnz_max)[block_id]
    for chunk in source.chunks(chunk_rows):
        acc.add(chunk.indices, chunk.values)
    return acc.finalize(lane_multiple)


def _assemble(partition, acc, labels_parts, stats, lane_multiple, source):
    q = partition.num_blocks
    block_indices, block_values, block_nnz_col = [], [], []
    for l in range(q):
        idx, val, nnz_col = acc[l].finalize(lane_multiple)
        block_indices.append(torch.from_numpy(idx))
        block_values.append(torch.from_numpy(val))
        block_nnz_col.append(torch.from_numpy(nnz_col))
    labels = (
        np.concatenate(labels_parts)
        if labels_parts
        else np.zeros((0,), np.float32)
    )
    if labels.shape[0] != stats.num_instances:
        raise ValueError(
            f"source {source.name!r} declared {stats.num_instances} "
            f"instances but yielded {labels.shape[0]} rows"
        )
    return BlockCSR(
        partition=partition,
        indices=tuple(block_indices),
        values=tuple(block_values),
        labels=torch.from_numpy(labels),
        dim=stats.dim,
        nnz_col=tuple(block_nnz_col),
        nnz_max=stats.nnz_max,
    )


# ---------------------------------------------------------------------------
# Streaming inference helpers (serving without materializing)
# ---------------------------------------------------------------------------


def streamed_margins(
    source: DataSource,
    w,
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    use_kernels: bool = True,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """``w^T x_i`` for every row of ``source``, one chunk at a time, as a
    NumPy array.

    ``w`` is ``[d]`` (returns ``[n]``) or multi-output ``[d, k]`` (returns
    ``[n, k]`` in one pass over the source, column ``j`` computed exactly
    as the ``k = 1`` call with ``w[:, j]``).  Each chunk goes to
    ``device`` (default ``cuda``; raises without one) and through
    :func:`repro_torch.serve.engine.batched_margins`: with
    ``use_kernels`` the margin kernel on the card (float32 only), the
    plain ``margins_rows`` otherwise and on the CPU.
    """
    from repro_torch.core.driver import resolve_device
    from repro_torch.serve.engine import batched_margins

    device = resolve_device(device)
    w = torch.as_tensor(w)
    if w.dim() not in (1, 2):
        raise ValueError(f"w must be [d] or [d, k], got shape {tuple(w.shape)}")
    w = w.to(device)
    parts = [
        batched_margins(chunk.indices, chunk.values, w,
                        use_kernels=use_kernels, device=device)
        for chunk in source.chunks(chunk_rows)
    ]
    if parts:
        return np.concatenate(parts)
    shape = (0,) if w.dim() == 1 else (0, int(w.shape[1]))
    return w.new_zeros(shape).cpu().numpy()


def source_labels(
    source: DataSource, *, chunk_rows: int = DEFAULT_CHUNK_ROWS
) -> np.ndarray:
    """The canonical {-1, +1} labels, streamed."""
    parts = [chunk.labels for chunk in source.chunks(chunk_rows)]
    return (
        np.concatenate(parts) if parts else np.zeros((0,), dtype=np.float32)
    )
