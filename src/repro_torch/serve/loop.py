"""The serve loop: request traffic micro-batched onto a frozen model.

Port of ``repro.serve.loop`` in its frozen-model mode
(``classifier=None``).  Requests stream in (the rows of a
:class:`~repro_torch.data.pipeline.DataSource`, each trimmed to its
stored entries so nnz varies per request), are micro-batched by the
:class:`~repro_torch.serve.batching.MicroBatcher` and scored by the
:class:`~repro_torch.serve.engine.PredictionEngine`.  A batch pins the
engine's snapshot when it is flushed and is scored with that snapshot;
per-request ``staleness`` is the number of versions published between
pin and serve.  The interleaved online-update mode (``partial_fit`` on
the stream) needs the fitted estimator and comes with the front door,
ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.data.pipeline import ArraySource, DataSource, as_source
from repro_torch.data.sparse import PaddedCSR
from repro_torch.serve.batching import Batch, MicroBatcher
from repro_torch.serve.engine import PredictionEngine


@dataclasses.dataclass(frozen=True)
class ServedRequest:
    """One request's serving record."""

    req_id: int
    margin: np.ndarray  # scalar () for binary, [k] for multi-output
    latency_s: float  # enqueue -> served (includes batching delay)
    version_used: int  # the batch's pinned snapshot version
    staleness: int  # versions published between pin and serve


@dataclasses.dataclass
class ServeReport:
    """What one serve-loop run measured."""

    served: list[ServedRequest]
    num_batches: int
    serve_wall_s: float  # engine compute time only
    total_wall_s: float  # whole loop
    versions_published: int
    updates_skipped: int
    bucket_counts: dict[tuple[int, int], int]
    flush_causes: dict[str, int]
    compiled_shapes: int

    @property
    def num_requests(self) -> int:
        return len(self.served)

    @property
    def predictions_per_s(self) -> float:
        if self.serve_wall_s <= 0:
            return 0.0
        return self.num_requests / self.serve_wall_s

    def latency_percentiles(self, qs=(50, 99)) -> dict[str, float]:
        lats = np.asarray([r.latency_s for r in self.served])
        if lats.size == 0:
            return {f"p{q}_ms": 0.0 for q in qs}
        return {
            f"p{q}_ms": float(np.percentile(lats, q) * 1e3) for q in qs
        }

    def staleness_histogram(self) -> dict[int, int]:
        hist: dict[int, int] = {}
        for r in self.served:
            hist[r.staleness] = hist.get(r.staleness, 0) + 1
        return hist

    def margins(self) -> np.ndarray:
        """All served margins in request-id order, ``[n]`` or ``[n, k]``."""
        order = sorted(self.served, key=lambda r: r.req_id)
        return np.stack([np.asarray(r.margin) for r in order])


def _chunk_requests(chunk):
    """Split one RowChunk into per-row (indices, values) with padding and
    explicit zeros trimmed: requests carry only stored entries."""
    mask = np.asarray(chunk.values) != 0.0
    idx = np.asarray(chunk.indices)
    val = np.asarray(chunk.values)
    for r in range(idx.shape[0]):
        m = mask[r]
        yield idx[r, m], val[r, m]


def run_serve_loop(
    source,
    engine: PredictionEngine,
    batcher: MicroBatcher,
    *,
    classifier=None,
    chunk_rows: int = 64,
    limit_rows: int | None = None,
    clock=time.perf_counter,
) -> ServeReport:
    """Drive ``source``'s rows through ``batcher`` and ``engine`` against
    the engine's frozen snapshot.  ``classifier`` must be ``None``: the
    interleaved updates come with ROADMAP queue 1 item 7."""
    if classifier is not None:
        raise NotImplementedError(
            "run_serve_loop serves a frozen model only (classifier=None): the "
            "interleaved partial_fit updates need the fitted estimator, which "
            "comes with the front door, ROADMAP queue 1 item 7"
        )
    source = as_source(source)
    dim = source.stats().dim
    if engine.snapshot.dim != dim:
        raise ValueError(
            f"engine serves dim={engine.snapshot.dim}, source rows have "
            f"dim={dim}"
        )

    served: list[ServedRequest] = []
    serve_wall = 0.0
    num_batches = 0
    rows_seen = 0

    def score(batches: list[Batch]) -> None:
        nonlocal serve_wall, num_batches
        for batch in batches:
            snap = batch.snapshot
            t0 = clock()
            out = engine.margins(batch.indices, batch.values, snapshot=snap)
            t1 = clock()
            serve_wall += t1 - t0
            num_batches += 1
            latest = engine.version
            for r, req in enumerate(batch.requests):
                served.append(
                    ServedRequest(
                        req_id=req.req_id,
                        margin=out[r],
                        latency_s=t1 - req.t_enqueue,
                        version_used=snap.version,
                        staleness=latest - snap.version,
                    )
                )

    def pin(batches: list[Batch]) -> list[Batch]:
        for b in batches:
            b.snapshot = engine.snapshot
        return batches

    t_start = clock()
    for chunk in source.chunks(chunk_rows):
        if limit_rows is not None and rows_seen >= limit_rows:
            break
        rows_seen += chunk.indices.shape[0]
        for idx, val in _chunk_requests(chunk):
            batcher.submit(idx, val)
        score(pin(batcher.ready()))
    # end of stream: deadline-flush whatever is left, then drain
    score(pin(batcher.ready()))
    score(pin(batcher.drain()))
    total_wall = clock() - t_start

    return ServeReport(
        served=served,
        num_batches=num_batches,
        serve_wall_s=serve_wall,
        total_wall_s=total_wall,
        versions_published=0,
        updates_skipped=0,
        bucket_counts=dict(batcher.bucket_counts),
        flush_causes=dict(batcher.flush_causes),
        compiled_shapes=len(engine.compiled_shapes),
    )


def synthetic_request_source(
    *,
    dim: int,
    num_requests: int,
    nnz_lo: int = 4,
    nnz_hi: int = 64,
    seed: int = 0,
    name: str = "requests",
) -> DataSource:
    """A planted-separator request stream with per-row varying nnz: rows
    store ``nnz_i ~ U[nnz_lo, nnz_hi]`` entries (random ids, unit-scale
    values) padded to ``nnz_hi``, labels the sign of the margin against a
    hidden ``w*``.  The reference's NumPy draws, so the same rows byte for
    byte for the same seed."""
    if not 1 <= nnz_lo <= nnz_hi <= dim:
        raise ValueError(
            f"need 1 <= nnz_lo <= nnz_hi <= dim, got "
            f"({nnz_lo}, {nnz_hi}, {dim})"
        )
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=dim).astype(np.float32)
    indices = np.zeros((num_requests, nnz_hi), dtype=np.int32)
    values = np.zeros((num_requests, nnz_hi), dtype=np.float32)
    nnz = rng.integers(nnz_lo, nnz_hi + 1, size=num_requests)
    for r in range(num_requests):
        k = int(nnz[r])
        indices[r, :k] = rng.choice(dim, size=k, replace=False)
        values[r, :k] = rng.normal(size=k).astype(np.float32)
    margins = np.einsum("rk,rk->r", w_star[indices], values)
    labels = np.where(margins > 0, 1.0, -1.0).astype(np.float32)
    return ArraySource(
        PaddedCSR(
            indices=torch.from_numpy(indices),
            values=torch.from_numpy(values),
            labels=torch.from_numpy(labels),
            dim=dim,
        ),
        name=name,
    )
