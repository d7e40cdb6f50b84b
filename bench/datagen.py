"""Wide sparse classification data from a seed, made on the device.

The distribution is the paper-shaped synthetic set the port's tests use:
feature ids drawn by Zipf-like popularity (a continuous Pareto inverse
CDF) and scattered over the id space by a fixed multiplier, positive
gamma(2, 1) values normalised per row, and labels from a planted sparse
teacher on the most popular ids, cut at its median margin so that the
classes are even as in news20.binary, with 2% of them flipped.  Unlike the
port's generator, which leaves about half of a wide row as repeats of a
few popular ids, a row here holds each id once, as a row of the LibSVM
sets does; so every row has norm 1, and the step size of the paper's
operating point is stable.  It is written again here in PyTorch, so
that the yardstick stays fixed whatever the program's own generator
becomes, and so that a set of 30 million entries is drawn on the card in
a fraction of a second instead of on the host.

Every draw comes from one ``torch.Generator`` on the target device, in a
fixed order: the same seed and device type give the same bytes, which is
what lets every rank of a multi-card cell make its own copy.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PERM_MULT = 2654435761  # Knuth's multiplicative hash: popular ranks spread over blocks
PERM_ADD = 12345


@dataclasses.dataclass(frozen=True)
class SparseSet:
    """A padded-row sparse design matrix: every row holds ``nnz`` entries."""

    indices: torch.Tensor  # int32[N, nnz], global feature ids
    values: torch.Tensor  # float32[N, nnz]
    labels: torch.Tensor  # float32[N] in {-1, +1}
    dim: int

    @property
    def num_instances(self) -> int:
        return int(self.indices.shape[0])

    def fingerprint(self) -> tuple[int, float, float]:
        """Sums of ids, values and labels: equal sets give equal prints."""
        return (int(self.indices.to(torch.int64).sum()),
                float(self.values.to(torch.float64).sum()),
                float(self.labels.to(torch.float64).sum()))


def make_sparse(*, dim: int, num_instances: int, nnz_per_instance: int, seed: int,
                device: torch.device | str, zipf_a: float = 1.3, label_noise: float = 0.02,
                teacher_nnz_frac: float = 0.05) -> SparseSet:
    """Draw the set of ``num_instances`` rows of ``nnz_per_instance`` ids in
    ``[0, dim)`` from ``seed`` on ``device``."""
    if not 1 <= nnz_per_instance < dim:
        raise ValueError(f"need 1 <= nnz_per_instance < dim, got {nnz_per_instance}, {dim}")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    shape = (num_instances, nnz_per_instance)

    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    top = dim - nnz_per_instance  # room to move every repeat up within [0, dim)
    raw = torch.clamp(u.pow(-1.0 / (zipf_a - 1.0)) - 1.0, max=float(top))
    ranks = torch.sort(raw.floor().to(torch.int64).clamp_(0, top - 1), dim=1).values
    # A row holds each feature once, as a LibSVM row does: a repeated rank
    # moves up to the next rank the row does not hold yet (the least
    # strictly increasing sequence at or above the sorted draws).
    steps = torch.arange(nnz_per_instance, device=device, dtype=torch.int64)
    ranks = torch.cummax(ranks - steps, dim=1).values + steps
    mult = PERM_MULT % dim
    if math.gcd(mult, dim) != 1:
        # Distinct ranks would not stay distinct ids, and the teacher's ids
        # below would repeat.
        raise ValueError(f"dim {dim} shares a factor with the id multiplier {PERM_MULT}")
    indices = (ranks * mult + PERM_ADD) % dim
    del u, raw, ranks

    values = torch._standard_gamma(torch.full(shape, 2.0, device=device), generator=gen)
    values = values / torch.clamp_min(torch.linalg.vector_norm(values, dim=1, keepdim=True), 1e-8)

    teacher_nnz = max(1, int(dim * teacher_nnz_frac))
    teacher_ids = (torch.arange(teacher_nnz, device=device, dtype=torch.int64) * mult
                   + PERM_ADD) % dim  # distinct: the multiplier is prime to dim
    teacher = torch.zeros(dim, device=device, dtype=torch.float32)
    teacher[teacher_ids] = torch.randn(teacher_nnz, generator=gen, device=device)
    margins = (values * teacher[indices]).sum(dim=1)
    del teacher
    labels = torch.sign(margins - torch.median(margins) + 1e-12)
    flip = torch.rand(num_instances, generator=gen, device=device) < label_noise
    labels = torch.where(flip, -labels, labels)
    labels = torch.where(labels == 0, torch.ones_like(labels), labels)
    return SparseSet(indices=indices.to(torch.int32).contiguous(),
                     values=values.to(torch.float32).contiguous(),
                     labels=labels.to(torch.float32).contiguous(), dim=dim)
