"""Synthetic high-dimensional sparse linear-classification data (d >> N).

Port of ``repro.data.synthetic.make_sparse_classification`` and
``make_dense_classification``: the same numpy draws in the same order, so
the generated bytes are identical to the reference's for the same
parameters; only the container differs (torch tensors on the CPU for the
sparse set, numpy arrays for the dense one, as the reference returns).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.sparse import PaddedCSR

# Mirrors the reference's generator version: bump whenever generated bytes
# change for the same parameters.
GENERATOR_VERSION = 1


def make_sparse_classification(
    *,
    dim: int,
    num_instances: int,
    nnz_per_instance: int,
    seed: int = 0,
    zipf_a: float = 1.3,
    label_noise: float = 0.02,
    teacher_nnz_frac: float = 0.05,
) -> PaddedCSR:
    """Generate a PaddedCSR data set with a planted sparse separator.

    Feature ids follow a Zipf-like popularity distribution, values are
    positive tf-idf-like weights normalized per instance, and labels come
    from a sparse teacher on the popular ids plus label noise.
    """
    rng = np.random.default_rng(seed)

    # Inverse-CDF draw on a continuous Pareto approximation of the Zipf
    # popularity ranking.
    u = rng.random((num_instances, nnz_per_instance))
    raw = u ** (-1.0 / (zipf_a - 1.0)) - 1.0
    raw = np.minimum(raw, float(dim))  # clamp before the int cast (u ~ 0)
    ranks = np.clip(np.floor(raw).astype(np.int64), 0, dim - 1)
    # Scatter popular ranks across the id space deterministically so blocks
    # are statistically balanced.
    perm_mult = 2654435761 % dim
    indices = (ranks * perm_mult + 12345) % dim

    # Deduplicate within an instance by nudging collisions (cheap, rare).
    for _ in range(2):
        sort_ix = np.argsort(indices, axis=1)
        srt = np.take_along_axis(indices, sort_ix, axis=1)
        dup = np.zeros_like(srt, dtype=bool)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        bump = np.zeros_like(indices)
        np.put_along_axis(bump, sort_ix, dup.astype(np.int64), axis=1)
        indices = (indices + bump * 97) % dim

    values = rng.gamma(2.0, 1.0, size=(num_instances, nnz_per_instance)).astype(
        np.float32
    )
    norms = np.linalg.norm(values, axis=1, keepdims=True)
    values = values / np.maximum(norms, 1e-8)

    # Planted sparse teacher on the most popular feature ids.
    teacher_nnz = max(1, int(dim * teacher_nnz_frac))
    teacher_ids = (np.arange(teacher_nnz, dtype=np.int64) * perm_mult + 12345) % dim
    teacher = np.zeros(dim, dtype=np.float32)
    teacher[teacher_ids] = rng.normal(0.0, 1.0, size=teacher_nnz).astype(np.float32)

    margins = np.einsum(
        "ij,ij->i", values, teacher[indices].astype(np.float32)
    )
    labels = np.sign(margins + 1e-12)
    flip = rng.random(num_instances) < label_noise
    labels = np.where(flip, -labels, labels).astype(np.float32)
    labels = np.where(labels == 0, 1.0, labels)

    return PaddedCSR(
        indices=torch.from_numpy(indices.astype(np.int32)),
        values=torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32)),
        labels=torch.from_numpy(np.asarray(labels, dtype=np.float32)),
        dim=dim,
    )


def make_dense_classification(
    *, dim: int, num_instances: int, seed: int = 0, label_noise: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Small dense problem (tests): returns (D [d x N], y [N])."""
    rng = np.random.default_rng(seed)
    D = rng.normal(0.0, 1.0, size=(dim, num_instances)).astype(np.float32)
    D /= np.maximum(np.linalg.norm(D, axis=0, keepdims=True), 1e-8)
    teacher = rng.normal(0.0, 1.0, size=dim).astype(np.float32)
    y = np.sign(teacher @ D)
    flip = rng.random(num_instances) < label_noise
    y = np.where(flip, -y, y).astype(np.float32)
    y = np.where(y == 0, 1.0, y)
    return D, y
