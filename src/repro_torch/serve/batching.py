"""Request micro-batching onto a bounded set of padded shapes.

Port of ``repro.serve.batching`` (host only, copied).  Serving traffic
is ragged — every request is a sparse row with its own nnz — so the
batcher quantizes both axes to powers of two:

* **width buckets**: a request with ``nnz`` stored entries lands in the
  bucket of width ``bucket_width(nnz)`` (next power of two, floored at
  ``min_width``), and shares a batch only with same-bucket peers;
* **row buckets**: a flushed batch pads its row count up to the next
  power of two (<= ``max_batch``).

The shape universe is therefore at most ``log2(max_batch) ·
log2(max_width)`` shapes, independent of traffic, and metered
(``PredictionEngine.compiled_shapes`` counts what was scored,
``MicroBatcher.bucket_counts`` what flushed).

Flush policy: a bucket flushes when it holds ``max_batch`` requests or
when its oldest request has waited ``max_delay_s``, checked at every
:meth:`MicroBatcher.ready` poll.  Padded rows are independent (sliced off
after the kernel) and padded lanes are ``(index 0, value 0.0)`` entries
that add exact zeros.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


def bucket_width(nnz: int, *, min_width: int = 8) -> int:
    """The padded nnz width a request with ``nnz`` entries buckets to:
    the next power of two, floored at ``min_width``."""
    if nnz < 0:
        raise ValueError(f"nnz must be >= 0, got {nnz}")
    width = min_width
    while width < nnz:
        width <<= 1
    return width


def _pow2_rows(n: int) -> int:
    rows = 1
    while rows < n:
        rows <<= 1
    return rows


@dataclasses.dataclass(frozen=True)
class Request:
    """One sparse prediction request: global feature ids + values."""

    req_id: int
    indices: np.ndarray  # int32[nnz]
    values: np.ndarray  # float[nnz]
    t_enqueue: float

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


@dataclasses.dataclass
class Batch:
    """A flushed, padded micro-batch.  ``indices``/``values`` are the
    bucket-shaped ``[rows, width]`` arrays (rows ``n_valid:`` are
    padding); ``snapshot`` is pinned by the serve loop at flush time —
    the model version this batch will be scored with, regardless of
    publishes that land before the compute runs."""

    requests: tuple[Request, ...]
    indices: np.ndarray  # int32[rows, width]
    values: np.ndarray  # float[rows, width]
    t_flush: float
    cause: str  # "full" | "deadline" | "drain"
    snapshot: object | None = None

    @property
    def n_valid(self) -> int:
        return len(self.requests)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.indices.shape)


class MicroBatcher:
    """Accumulates requests into power-of-two buckets; flushes on size
    or deadline.  Single-owner object (the serve loop) — no locking."""

    def __init__(
        self,
        *,
        max_batch: int = 256,
        max_delay_s: float = 0.002,
        min_width: int = 8,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if max_batch < 1 or (max_batch & (max_batch - 1)) != 0:
            raise ValueError(
                f"max_batch must be a power of two >= 1, got {max_batch}"
            )
        if min_width < 1 or (min_width & (min_width - 1)) != 0:
            raise ValueError(
                f"min_width must be a power of two >= 1, got {min_width}"
            )
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.min_width = min_width
        self.clock = clock
        self._buckets: dict[int, list[Request]] = {}
        self._next_id = 0
        # flushed-shape histogram {(rows, width): count} and flush causes
        self.bucket_counts: dict[tuple[int, int], int] = {}
        self.flush_causes: dict[str, int] = {}

    @property
    def pending(self) -> int:
        return sum(len(reqs) for reqs in self._buckets.values())

    def submit(self, indices, values, *, now: float | None = None) -> Request:
        """Enqueue one sparse request; returns its :class:`Request`
        record (the id is the submission counter)."""
        idx = np.asarray(indices, dtype=np.int32).reshape(-1)
        val = np.asarray(values).reshape(-1)
        if idx.shape != val.shape:
            raise ValueError(
                f"indices/values length mismatch: {idx.shape} vs {val.shape}"
            )
        req = Request(
            req_id=self._next_id,
            indices=idx,
            values=val,
            t_enqueue=self.clock() if now is None else now,
        )
        self._next_id += 1
        self._buckets.setdefault(
            bucket_width(req.nnz, min_width=self.min_width), []
        ).append(req)
        return req

    def ready(self, now: float | None = None) -> list[Batch]:
        """Flush and return every bucket that is full or past deadline."""
        now = self.clock() if now is None else now
        out = []
        for width in sorted(self._buckets):
            reqs = self._buckets[width]
            while len(reqs) >= self.max_batch:
                out.append(
                    self._flush(width, reqs[: self.max_batch], "full", now)
                )
                del reqs[: self.max_batch]
            if reqs and now - reqs[0].t_enqueue >= self.max_delay_s:
                out.append(self._flush(width, reqs, "deadline", now))
                self._buckets[width] = []
        return out

    def drain(self, now: float | None = None) -> list[Batch]:
        """Flush everything (end of stream / shutdown)."""
        now = self.clock() if now is None else now
        out = []
        for width, reqs in sorted(self._buckets.items()):
            for lo in range(0, len(reqs), self.max_batch):
                out.append(
                    self._flush(
                        width, reqs[lo : lo + self.max_batch], "drain", now
                    )
                )
        self._buckets.clear()
        return out

    def _flush(self, width: int, reqs: list[Request], cause: str,
               now: float) -> Batch:
        rows = min(_pow2_rows(len(reqs)), self.max_batch)
        dtype = reqs[0].values.dtype
        indices = np.zeros((rows, width), dtype=np.int32)
        values = np.zeros((rows, width), dtype=dtype)
        for r, req in enumerate(reqs):
            indices[r, : req.nnz] = req.indices
            values[r, : req.nnz] = req.values
        shape = (rows, width)
        self.bucket_counts[shape] = self.bucket_counts.get(shape, 0) + 1
        self.flush_causes[cause] = self.flush_causes.get(cause, 0) + 1
        return Batch(
            requests=tuple(reqs),
            indices=indices,
            values=values,
            t_flush=now,
            cause=cause,
        )
