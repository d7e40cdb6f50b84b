"""Feature partitioning (paper §4.1: D split horizontally into q blocks).

Port of ``repro.core.partition`` (pure numpy, copied so the port stands
alone).

A partition is a list of contiguous [lo, hi) feature ranges covering
[0, d) exactly once.  Contiguity keeps each worker's block a dense,
contiguous slice of w (a view, no copy).

Two strategies:
  * ``balanced`` — equal feature counts (paper default: d_l = d/q).
  * ``by_nnz``   — equalize the number of nonzeros per block, which
    balances *compute* when feature popularity is skewed (text data).
    The synthetic generator scatters popular ids uniformly so both are
    close, but real text data is not.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FeaturePartition:
    dim: int
    bounds: tuple[int, ...]  # length q+1, bounds[0]=0, bounds[-1]=dim

    @property
    def num_blocks(self) -> int:
        return len(self.bounds) - 1

    def block(self, l: int) -> tuple[int, int]:
        return self.bounds[l], self.bounds[l + 1]

    def block_sizes(self) -> list[int]:
        return [self.bounds[i + 1] - self.bounds[i] for i in range(self.num_blocks)]

    def owner_of(self, feature: int) -> int:
        return int(np.searchsorted(np.asarray(self.bounds), feature, side="right") - 1)


def balanced(dim: int, q: int) -> FeaturePartition:
    if not 1 <= q <= dim:
        raise ValueError(f"need 1 <= q <= dim, got q={q}, dim={dim}")
    base, rem = divmod(dim, q)
    bounds = [0]
    for l in range(q):
        bounds.append(bounds[-1] + base + (1 if l < rem else 0))
    return FeaturePartition(dim=dim, bounds=tuple(bounds))


def by_nnz(dim: int, q: int, feature_counts: np.ndarray) -> FeaturePartition:
    """Contiguous partition equalizing per-block nnz mass.

    feature_counts[j] = number of instances touching feature j (or any
    nonnegative weight).  Greedy prefix-sum cut at multiples of total/q.
    """
    if feature_counts.shape != (dim,):
        raise ValueError("feature_counts must have shape (dim,)")
    if q == 1:
        return FeaturePartition(dim=dim, bounds=(0, dim))
    # +1 smoothing so empty features still take space and bounds stay strictly
    # increasing even for pathological count vectors.
    weights = feature_counts.astype(np.float64) + 1.0
    csum = np.cumsum(weights)
    total = csum[-1]
    targets = total * np.arange(1, q) / q
    cuts = np.searchsorted(csum, targets, side="left") + 1
    # Enforce strict monotonicity and range validity.
    bounds = [0]
    for c in cuts:
        c = int(min(max(c, bounds[-1] + 1), dim - (q - len(bounds))))
        bounds.append(c)
    bounds.append(dim)
    return FeaturePartition(dim=dim, bounds=tuple(bounds))


def feature_counts(indices: np.ndarray, values: np.ndarray, dim: int) -> np.ndarray:
    """Per-feature nnz counts from padded-CSR arrays."""
    counts = np.zeros(dim, dtype=np.int64)
    mask = values != 0.0
    np.add.at(counts, indices[mask], 1)
    return counts
