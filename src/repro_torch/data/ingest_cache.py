"""On-disk BlockCSR slab cache: parse once, sweep forever.

Port of ``repro.data.ingest_cache``, with the same on-disk format and
key, so each package reads a cache the other wrote:

    <cache_dir>/<key>/
        manifest.json     version, source digest, dim/N/nnz_max,
                          partition bounds, lane_multiple, dtypes
        labels.npy        float[N] canonical {-1, +1}
        slab_0000.npz     indices, values, nnz_col, lanes for worker 0
        ...

The key hashes ``(format version, source digest, partition bounds,
lane_multiple)``; ``chunk_rows`` is not part of it, since the streamed
build is the same bytes for every chunk size.  Writes are atomic (a temp
dir moved into place).  Slabs are stored compressed with trailing
all-padding lanes trimmed and re-padded on load, so the loaded arrays
are byte for byte what was saved.  Loaded tensors lie on the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.pipeline import (
    DEFAULT_CHUNK_ROWS,
    DataSource,
    stream_block_csr,
    stream_block_slab,
)

# v2: compressed slabs with trailing padding lanes trimmed (+ "lanes" key
# per slab); the reference's format version.
CACHE_VERSION = 2


def _trim_padding_lanes(
    indices: np.ndarray, values: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Drop trailing lanes that are pure ``(index 0, value 0.0)`` padding in
    every row; at least one lane is kept."""
    used = (indices != 0) | (values != 0)
    lane_used = used.any(axis=0) if indices.size else np.zeros(0, dtype=bool)
    if lane_used.any():
        keep = int(np.max(np.nonzero(lane_used)[0])) + 1
    else:
        keep = min(1, indices.shape[1])
    return indices[:, :keep], values[:, :keep]


@dataclasses.dataclass(frozen=True)
class CacheOutcome:
    """What :func:`get_or_build` did."""

    data: BlockCSR
    status: str  # "warm" (loaded), "cold" (built + saved), "off" (no dir)
    path: str | None


def cache_key(digest: str, partition, lane_multiple: int) -> str:
    """Directory name for one (source, partition, padding) combination."""
    h = hashlib.sha256()
    h.update(
        f"v{CACHE_VERSION}:{digest}:dim={partition.dim}:"
        f"bounds={tuple(partition.bounds)}:lane={lane_multiple}".encode()
    )
    return h.hexdigest()[:24]


def save_block_csr(
    cache_dir: str,
    digest: str,
    block_data: BlockCSR,
    *,
    lane_multiple: int = 1,
    source_name: str = "?",
) -> str:
    """Persist slabs under ``cache_dir``; returns the entry path."""
    key = cache_key(digest, block_data.partition, lane_multiple)
    entry = os.path.join(cache_dir, key)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{key}.", dir=cache_dir)
    try:
        labels = block_data.labels.cpu().numpy()
        np.save(os.path.join(tmp, "labels.npy"), labels)
        for l in range(block_data.num_blocks):
            indices = block_data.indices[l].cpu().numpy()
            values = block_data.values[l].cpu().numpy()
            t_indices, t_values = _trim_padding_lanes(indices, values)
            np.savez_compressed(
                os.path.join(tmp, f"slab_{l:04d}.npz"),
                indices=t_indices,
                values=t_values,
                nnz_col=block_data.nnz_col_block(l).cpu().numpy(),
                # Full padded lane count, so the load re-pads exactly.
                lanes=np.int64(indices.shape[1]),
            )
        manifest = {
            "version": CACHE_VERSION,
            "digest": digest,
            "source_name": source_name,
            "dim": block_data.dim,
            "num_instances": block_data.num_instances,
            "nnz_max": block_data.global_nnz_max(),
            "bounds": list(block_data.partition.bounds),
            "lane_multiple": lane_multiple,
            "labels_dtype": str(labels.dtype),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(entry):  # lost a race; the other build is identical
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, entry)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return entry


def load_block_csr(
    cache_dir: str, digest: str, partition, *, lane_multiple: int = 1
) -> BlockCSR | None:
    """A warm entry's BlockCSR (CPU tensors), or None on any miss or
    mismatch."""
    entry = os.path.join(cache_dir, cache_key(digest, partition, lane_multiple))
    manifest_path = os.path.join(entry, "manifest.json")
    if not os.path.isfile(manifest_path):
        return None
    with open(manifest_path) as f:
        manifest = json.load(f)
    if (
        manifest.get("version") != CACHE_VERSION
        or manifest.get("digest") != digest
        or manifest.get("bounds") != list(partition.bounds)
        or manifest.get("dim") != partition.dim
    ):
        return None  # key collision or stale format: rebuild, don't trust
    q = partition.num_blocks
    block_indices, block_values, block_nnz_col = [], [], []
    for l in range(q):
        slab_path = os.path.join(entry, f"slab_{l:04d}.npz")
        if not os.path.isfile(slab_path):
            return None
        with np.load(slab_path) as slab:
            indices = slab["indices"]
            values = slab["values"]
            lanes = int(slab["lanes"])
            if indices.shape[1] < lanes:
                # Restore the trimmed trailing padding lanes (zeros).
                pad = ((0, 0), (0, lanes - indices.shape[1]))
                indices = np.pad(indices, pad)
                values = np.pad(values, pad)
            block_indices.append(torch.from_numpy(np.ascontiguousarray(indices)))
            block_values.append(torch.from_numpy(np.ascontiguousarray(values)))
            block_nnz_col.append(torch.from_numpy(slab["nnz_col"]))
    labels = np.load(os.path.join(entry, "labels.npy"))
    return BlockCSR(
        partition=partition,
        indices=tuple(block_indices),
        values=tuple(block_values),
        labels=torch.from_numpy(labels),
        dim=partition.dim,
        nnz_col=tuple(block_nnz_col),
        nnz_max=int(manifest["nnz_max"]),
    )


def get_or_build(
    source: DataSource,
    partition,
    *,
    cache_dir: str | None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    lane_multiple: int = 1,
) -> CacheOutcome:
    """The one ingestion entry point: warm load or streamed build + save.
    With ``cache_dir=None`` caching is off and this is
    :func:`~repro_torch.data.pipeline.stream_block_csr`.  A warm hit never
    parses the source (a LibSVM file is hashed, not tokenized)."""
    if cache_dir is None:
        return CacheOutcome(
            data=stream_block_csr(
                source, partition, chunk_rows=chunk_rows, lane_multiple=lane_multiple
            ),
            status="off",
            path=None,
        )
    digest = source.digest()
    cached = load_block_csr(
        cache_dir, digest, partition, lane_multiple=lane_multiple
    )
    if cached is not None:
        entry = os.path.join(
            cache_dir, cache_key(digest, partition, lane_multiple)
        )
        return CacheOutcome(data=cached, status="warm", path=entry)
    built = stream_block_csr(
        source, partition, chunk_rows=chunk_rows, lane_multiple=lane_multiple
    )
    entry = save_block_csr(
        cache_dir,
        digest,
        built,
        lane_multiple=lane_multiple,
        source_name=source.name,
    )
    return CacheOutcome(data=built, status="cold", path=entry)


__all__ = [
    "CACHE_VERSION",
    "CacheOutcome",
    "cache_key",
    "get_or_build",
    "load_block_csr",
    "save_block_csr",
    "stream_block_slab",
]
