"""The serve loop: inference traffic interleaved with online updates.

Port of ``repro.serve.loop``.  Requests stream in (the rows of a
:class:`~repro_torch.data.pipeline.DataSource`, each trimmed to its
stored entries so nnz varies per request), are micro-batched by the
:class:`~repro_torch.serve.batching.MicroBatcher` and scored by the
:class:`~repro_torch.serve.engine.PredictionEngine`; with a classifier,
the same traffic feeds ``FDSVRGClassifier.partial_fit`` in chunks, and
each update publishes a new :class:`~repro_torch.serve.engine.
WeightSnapshot` under the monotone version counter.

**The staleness contract.**  A batch pins the engine's snapshot when it
is flushed and is scored with that pinned snapshot even if a publish
lands before its compute runs.  Per-request ``staleness`` is the number
of versions published between pin and serve.  The loop is
single-threaded and deterministic: chunk t's flushed batches are scored
*after* chunk t's update publishes, so they are served at staleness 1.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.data.pipeline import ArraySource, DataSource, as_source
from repro_torch.data.sparse import PaddedCSR
from repro_torch.serve.batching import Batch, MicroBatcher
from repro_torch.serve.engine import PredictionEngine, WeightSnapshot


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
    total_wall_s: float  # whole loop, training included
    versions_published: int
    updates_skipped: int  # single-class chunks the trainer skipped
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


def _chunk_padded(chunk, dim: int) -> PaddedCSR:
    return PaddedCSR(
        indices=torch.as_tensor(chunk.indices),
        values=torch.as_tensor(chunk.values),
        labels=torch.as_tensor(chunk.labels),
        dim=dim,
    )


def run_serve_loop(
    source,
    engine: PredictionEngine,
    batcher: MicroBatcher,
    *,
    classifier=None,
    update_every_chunks: int = 1,
    train_outer_iters: int = 1,
    chunk_rows: int = 64,
    limit_rows: int | None = None,
    clock=time.perf_counter,
) -> ServeReport:
    """Drive ``source``'s rows through ``batcher`` and ``engine``,
    interleaving ``classifier.partial_fit`` every ``update_every_chunks``
    chunks.

    ``classifier=None`` serves a frozen model.  With a classifier (it must
    be fitted; the engine starts from its snapshot), each update trains on
    the chunk's rows with their stream labels and publishes
    ``engine.version + 1`` on the engine's device; a chunk whose labels
    are all one class is skipped (counted in ``updates_skipped``).
    """
    source = as_source(source)
    if classifier is not None and not classifier.is_fitted:
        raise ValueError(
            "run_serve_loop needs a fitted classifier (its coef_ is the "
            "version the engine starts serving)"
        )
    dim = source.stats().dim
    if engine.snapshot.dim != dim:
        raise ValueError(
            f"engine serves dim={engine.snapshot.dim}, source rows have "
            f"dim={dim}"
        )

    served: list[ServedRequest] = []
    serve_wall = 0.0
    num_batches = 0
    versions_published = 0
    updates_skipped = 0
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
    for ci, chunk in enumerate(source.chunks(chunk_rows)):
        if limit_rows is not None and rows_seen >= limit_rows:
            break
        rows_seen += chunk.indices.shape[0]
        # 1) this chunk's rows become requests
        for idx, val in _chunk_requests(chunk):
            batcher.submit(idx, val)
        # 2) flush what's ready, pinning the snapshot they see
        pending = pin(batcher.ready())
        # 3) the online update: train on this chunk, publish atomically;
        #    the pinned batches are scored after it, at staleness 1.
        if classifier is not None and (ci + 1) % update_every_chunks == 0:
            if np.unique(np.asarray(chunk.labels)).size < 2:
                updates_skipped += 1
            else:
                classifier.partial_fit(
                    _chunk_padded(chunk, dim), outer_iters=train_outer_iters
                )
                engine.publish(
                    WeightSnapshot.from_estimator(
                        classifier, engine.version + 1,
                        device=engine.snapshot.device,
                    )
                )
                versions_published += 1
        # 4) serve the in-flight batches
        score(pending)
    # end of stream: deadline-flush whatever is left, then drain
    score(pin(batcher.ready()))
    score(pin(batcher.drain()))
    total_wall = clock() - t_start

    return ServeReport(
        served=served,
        num_batches=num_batches,
        serve_wall_s=serve_wall,
        total_wall_s=total_wall,
        versions_published=versions_published,
        updates_skipped=updates_skipped,
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
