"""Chunked LibSVM text ingestion: parse, scan, write.

Port of ``repro.data.libsvm`` (host NumPy, copied so the port stands
alone).  The paper's data sets ship as LibSVM text:

    <label> <index>:<value> <index>:<value> ...   # optional comment

with **1-based** feature indices.  This module owns the text-level
operations; everything block- and worker-shaped lives in
:mod:`repro_torch.data.pipeline`:

* :func:`iter_libsvm_rows` / :func:`iter_libsvm_chunks` — a streaming
  parser holding one chunk of rows in memory at a time.  It handles the
  format's corners as the reference does: 1-based indices (made 0-based
  here, once), ``#`` comments (whole-line and trailing), blank lines,
  empty rows (label only), ranking ``qid:`` tokens (skipped), and
  duplicate feature ids (kept in file order: the scatter applies
  duplicates in program order, so order is part of the numerics).
* :func:`scan_libsvm` — the stats pass (N, max index, widest row, label
  alphabet) a streaming build needs before it can partition features or
  fix the label convention.
* :func:`write_libsvm` — the inverse.  Values are written with ``repr``,
  so a float32 survives the text round trip bit for bit.
* :func:`load_libsvm` — one-shot file -> :class:`PaddedCSR` (CPU
  tensors), built on the same chunk iterator (one parser: the streamed
  and one-shot paths cannot drift).

Label conventions (:func:`canonical_label_map`): +/-1 pass through,
{0,1} maps 0 -> -1, any other two-value alphabet maps (sorted) low -> -1
and high -> +1, decided from the file's *global* label alphabet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterator, TextIO

import numpy as np
import torch


class LibSVMFormatError(ValueError):
    """A malformed LibSVM line, with the 1-based line number."""


@dataclasses.dataclass(frozen=True)
class LibSVMStats:
    """What one stats pass over a file learns (see :func:`scan_libsvm`)."""

    num_instances: int
    max_index: int  # largest 0-based feature id seen; -1 if no entries
    nnz_max: int  # widest row (stored entries, explicit zeros included)
    nnz_total: int  # stored entries over the whole file
    label_values: tuple[float, ...]  # sorted unique raw labels


def _parse_line(
    line: str, lineno: int
) -> tuple[float, list[int], list[float]] | None:
    """One row -> (raw label, 0-based ids, values); None for non-data lines."""
    hash_at = line.find("#")
    if hash_at != -1:
        line = line[:hash_at]
    parts = line.split()
    if not parts:
        return None
    try:
        label = float(parts[0])
    except ValueError:
        raise LibSVMFormatError(
            f"line {lineno}: label {parts[0]!r} is not a number"
        ) from None
    ids: list[int] = []
    vals: list[float] = []
    for tok in parts[1:]:
        idx_s, sep, val_s = tok.partition(":")
        if not sep:
            raise LibSVMFormatError(
                f"line {lineno}: expected index:value, got {tok!r}"
            )
        if idx_s == "qid":  # ranking metadata, not a feature
            continue
        try:
            idx = int(idx_s)
            val = float(val_s)
        except ValueError:
            raise LibSVMFormatError(
                f"line {lineno}: expected index:value, got {tok!r}"
            ) from None
        if idx < 1:
            raise LibSVMFormatError(
                f"line {lineno}: LibSVM indices are 1-based, got {idx}"
            )
        ids.append(idx - 1)
        vals.append(val)
    return label, ids, vals


def iter_libsvm_rows(
    f: TextIO,
) -> Iterator[tuple[float, list[int], list[float]]]:
    """Data rows of an open LibSVM file, comments and blanks skipped."""
    for lineno, line in enumerate(f, start=1):
        row = _parse_line(line, lineno)
        if row is not None:
            yield row


def iter_libsvm_chunks(
    path: str, chunk_rows: int
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stream ``(raw_labels f64[c], indices i32[c, w], values f32[c, w])``.

    ``w`` is the widest row *within the chunk* (at least 1); shorter rows
    are left-aligned and padded with ``(0, 0.0)``, the global padded
    layout's convention.  Peak memory is one chunk, not the file.
    """
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows >= 1 required, got {chunk_rows}")
    with open(path, "r") as f:
        rows: list[tuple[float, list[int], list[float]]] = []
        for row in iter_libsvm_rows(f):
            rows.append(row)
            if len(rows) == chunk_rows:
                yield _pack_chunk(rows)
                rows = []
        if rows:
            yield _pack_chunk(rows)


def _pack_chunk(
    rows: list[tuple[float, list[int], list[float]]]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    c = len(rows)
    w = max(1, max(len(ids) for _, ids, _ in rows))
    labels = np.empty(c, dtype=np.float64)
    indices = np.zeros((c, w), dtype=np.int32)
    values = np.zeros((c, w), dtype=np.float32)
    for i, (label, ids, vals) in enumerate(rows):
        labels[i] = label
        k = len(ids)
        if k:
            indices[i, :k] = ids
            values[i, :k] = vals
    return labels, indices, values


def scan_libsvm(path: str, chunk_rows: int = 65536) -> LibSVMStats:
    """The stats pass: parse everything, keep nothing but counters."""
    n = 0
    max_index = -1
    nnz_max = 0
    nnz_total = 0
    label_values: set[float] = set()
    with open(path, "r") as f:
        for label, ids, vals in iter_libsvm_rows(f):
            n += 1
            label_values.add(label)
            nnz_max = max(nnz_max, len(ids))
            nnz_total += len(ids)
            if ids:
                max_index = max(max_index, max(ids))
    return LibSVMStats(
        num_instances=n,
        max_index=max_index,
        nnz_max=nnz_max,
        nnz_total=nnz_total,
        label_values=tuple(sorted(label_values)),
    )


def _map_labels(raw: np.ndarray, positive: float) -> np.ndarray:
    return np.where(np.asarray(raw) == positive, 1.0, -1.0).astype(np.float32)


def canonical_label_map(
    label_values: tuple[float, ...]
) -> Callable[[np.ndarray], np.ndarray]:
    """The one deterministic raw-labels -> {-1, +1} float32 rule, decided
    from the file's global label alphabet; more than two values is an
    error (binary classification).  The rule pickles, so a scanned
    :class:`~repro_torch.data.pipeline.LibSVMSource` can go to worker
    processes that each build their own slab."""
    uniq = tuple(sorted(set(float(v) for v in label_values)))
    if not uniq:
        raise ValueError("no labels: cannot infer a label convention")
    if len(uniq) > 2:
        raise ValueError(
            f"binary classification requires <= 2 label values, file has "
            f"{len(uniq)}: {uniq[:5]}..."
        )
    if set(uniq) <= {-1.0, 1.0}:
        positive = 1.0
    elif set(uniq) <= {0.0, 1.0}:
        positive = 1.0
    elif len(uniq) == 2:
        positive = uniq[1]
    else:
        raise ValueError(
            f"cannot infer a binary label convention from the single label "
            f"value {uniq[0]!r}; use -1/+1 or 0/1 coding"
        )
    return functools.partial(_map_labels, positive=positive)


def load_libsvm(path: str, *, dim: int | None = None, chunk_rows: int = 65536):
    """One-shot ``path`` -> :class:`~repro_torch.data.sparse.PaddedCSR` of
    CPU tensors, built on :func:`iter_libsvm_chunks`.  ``dim`` defaults to
    ``max index + 1``; pass the true dimensionality when trailing features
    are absent from the file."""
    from repro_torch.data.sparse import PaddedCSR

    raw_labels: list[np.ndarray] = []
    chunks: list[tuple[np.ndarray, np.ndarray]] = []
    width = 1
    max_index = -1
    for labels, indices, values in iter_libsvm_chunks(path, chunk_rows):
        raw_labels.append(labels)
        chunks.append((indices, values))
        width = max(width, indices.shape[1])
        if indices.size:
            # Padding ids are 0 and real ids nonnegative, so the plain max
            # is the max stored id (or 0 for an all-empty chunk).
            max_index = max(max_index, int(indices.max()))
    if not raw_labels:
        raise ValueError(f"{path}: no data rows")
    if dim is None:
        dim = max(max_index + 1, 1)
    elif dim <= max_index:
        raise ValueError(
            f"dim={dim} but {path} stores feature id {max_index} (0-based)"
        )
    all_raw = np.concatenate(raw_labels)
    mapper = canonical_label_map(tuple(np.unique(all_raw)))
    indices = np.vstack(
        [np.pad(i, ((0, 0), (0, width - i.shape[1]))) for i, _ in chunks]
    )
    values = np.vstack(
        [np.pad(v, ((0, 0), (0, width - v.shape[1]))) for _, v in chunks]
    )
    return PaddedCSR(
        indices=torch.from_numpy(indices),
        values=torch.from_numpy(values),
        labels=torch.from_numpy(mapper(all_raw)),
        dim=int(dim),
    )


def write_libsvm(path: str, data, *, comment: str | None = None) -> str:
    """Write a :class:`~repro_torch.data.sparse.PaddedCSR` as LibSVM text.

    Only stored nonzeros are written, 1-based, in each row's stored order.
    Values go through ``repr`` of the exact Python float, so parsing back
    gives the same float32 bits; whole-number labels are written as
    integers.  The text is the reference's byte for byte.
    """
    indices = np.asarray(data.indices)
    values = np.asarray(data.values)
    labels = np.asarray(data.labels)
    with open(path, "w") as f:
        if comment:
            f.write(f"# {comment}\n")
        for i in range(indices.shape[0]):
            row_mask = values[i] != 0.0
            lab = float(labels[i])
            parts = [str(int(lab)) if lab == int(lab) else repr(lab)]
            parts.extend(
                f"{idx + 1}:{val!r}"
                for idx, val in zip(indices[i, row_mask].tolist(),
                                    values[i, row_mask].tolist())
            )
            f.write(" ".join(parts) + "\n")
    return path
