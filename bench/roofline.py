"""The least time an FD-SVRG window could take on the card, and the peaks.

The work is what the cell's inputs need, whatever implements it, so the
count is the same for the dense and the exact-lazy route (the exact lazy
route computes the dense route's bits):

* every stored entry of the u sampled rows of a step, and of the N rows
  of a snapshot, is read once (a 4-byte id and a 4-byte value);
* every distinct feature id a step touches is read and written once in
  ``w`` and read once in ``z`` (12 bytes); the u rows' labels and snapshot
  margins are read once (8 bytes a row), and so are a snapshot's N labels
  and its N margins written (8 bytes a row);
* each d-length vector an outer needs, ``w`` and ``z``, is read once and
  written once (16 bytes a feature); the solve's first snapshot reads
  ``w`` and writes ``z`` (8 bytes a feature);
* operations, float32: a margin and a scatter each take a multiply and
  an add per entry (4 an entry); every feature's update chain of a step,
  ``w - eta * (g + z + lam * w)`` in the rounded order the bit contract
  keeps, takes 4 a feature and step, whether it runs at the step or is
  replayed later; a row's loss derivative counts 10.

Over a rank's block of features only the entries, ids and width of that
block count.  The least time is the larger of bytes over the peak
bandwidth and operations over the peak float32 rate, over the window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# NVIDIA H100 SXM5 80 GB data sheet, dense rates at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores

ENTRY_BYTES = 8  # int32 id + float32 value
TOUCHED_BYTES = 12  # w read and written, z read
ROW_BYTES = 8  # a label and a margin
OUTER_VECTOR_BYTES = 16  # w read + written, z written + read
FIRST_SNAPSHOT_VECTOR_BYTES = 8  # w read, z written
ENTRY_FLOPS = 4  # margin and scatter, a multiply and an add each
FEATURE_STEP_FLOPS = 4
ROW_FLOPS = 10


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    flops: float = 0.0

    def __iadd__(self, other: "Work") -> "Work":
        self.bytes += other.bytes
        self.flops += other.flops
        return self

    def least_seconds(self) -> tuple[float, str]:
        t_bytes = self.bytes / PEAK_BYTES_PER_S
        t_ops = self.flops / PEAK_F32_FLOP_PER_S
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def step_work(entries: int, distinct: int, u: int, width: int) -> Work:
    return Work(bytes=ENTRY_BYTES * entries + TOUCHED_BYTES * distinct + ROW_BYTES * u,
                flops=ENTRY_FLOPS * entries + FEATURE_STEP_FLOPS * width + ROW_FLOPS * u)


def snapshot_work(entries: int, n: int) -> Work:
    return Work(bytes=ENTRY_BYTES * entries + ROW_BYTES * n,
                flops=ENTRY_FLOPS * entries + ROW_FLOPS * n)


def outer_vector_work(width: int) -> Work:
    return Work(bytes=OUTER_VECTOR_BYTES * width)


def first_snapshot_vector_work(width: int) -> Work:
    return Work(bytes=FIRST_SNAPSHOT_VECTOR_BYTES * width)


def step_counts(indices: torch.Tensor, values: torch.Tensor, samples: np.ndarray, lo: int,
                hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per step of ``samples`` (int[M, u]): the stored entries of the u rows
    with ids in ``[lo, hi)``, and the distinct ids among them."""
    ids = torch.from_numpy(np.ascontiguousarray(samples, dtype=np.int64)).to(indices.device)
    flat = indices[ids].reshape(ids.shape[0], -1).to(torch.int64)
    keep = (flat >= lo) & (flat < hi) & (values[ids].reshape(ids.shape[0], -1) != 0)
    entries = keep.sum(dim=1)
    srt = torch.sort(torch.where(keep, flat, -1), dim=1).values
    starts = torch.ones_like(srt, dtype=torch.bool)
    starts[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = (starts & (srt >= 0)).sum(dim=1)
    return entries, distinct


def snapshot_entries(indices: torch.Tensor, values: torch.Tensor, lo: int, hi: int) -> int:
    return int(((indices >= lo) & (indices < hi) & (values != 0)).sum())


def window_work(indices: torch.Tensor, values: torch.Tensor, sample_draws: list[np.ndarray],
                lo: int, hi: int) -> Work:
    """The work of one solve: a first snapshot, then per outer (one array of
    samples each) its M steps, its d-length vectors and its snapshot."""
    n = int(indices.shape[0])
    width = hi - lo
    snap = snapshot_work(snapshot_entries(indices, values, lo, hi), n)
    work = Work()
    work += snap
    work += first_snapshot_vector_work(width)
    for samples in sample_draws:
        entries, distinct = step_counts(indices, values, samples, lo, hi)
        for e, t in zip(entries.tolist(), distinct.tolist()):
            work += step_work(e, t, samples.shape[1], width)
        work += outer_vector_work(width)
        work += snap
    return work
