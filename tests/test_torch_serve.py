"""The port's serving tier (``repro_torch.serve``) held against the
reference's (``repro.serve``), on the CPU.

Tolerances: the batcher is host code and held exactly (the flush
sequence, each batch's requests, shape, cause and padded arrays,
``bucket_counts``, ``flush_causes``), as is the request stream
(``synthetic_request_source``, byte for byte) and every count of the
serve loop's report (batches, shapes, ``compiled_shapes``, staleness).
Margins are float reductions the port runs in PyTorch and the reference
through XLA: held within ``MARGIN_RTOL`` of the sum of ``|w[idx] * val|``
per row; within the port a ``[d, k]`` snapshot's columns are bit for
bit the scalar passes, a block snapshot bit for bit the dense one, and
a served margin bit for bit the row scored alone at its bucket width.
The ``cuda``-marked cases hold the engine's kernel route against the
plain route on the card within ``MARGIN_RTOL``, and padding to the
bucket width bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.partition import balanced as r_balanced
from repro.serve import batching as r_batching
from repro.serve import engine as r_engine
from repro.serve import loop as r_loop

from repro_torch.serve import batching as t_batching
from repro_torch.serve import engine as t_engine
from repro_torch.serve import loop as t_loop

MARGIN_RTOL = 1e-6
STREAM = dict(dim=256, num_requests=300, nnz_lo=2, nnz_hi=16, seed=0)


def _scale(indices, values, w):
    idx, val = np.asarray(indices), np.asarray(values, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 2:
        return np.abs(w[idx] * val[..., None]).sum(axis=1)
    return np.abs(w[idx] * val).sum(axis=1)


class Clock:
    """A scripted clock: each read advances it by ``step`` seconds."""

    def __init__(self, step=0.0005):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def streams():
    return (r_loop.synthetic_request_source(**STREAM),
            t_loop.synthetic_request_source(**STREAM))


@pytest.fixture(scope="module")
def w():
    return np.random.default_rng(3).normal(size=STREAM["dim"]).astype(np.float32)


def test_synthetic_request_source_matches_reference_bytes(streams):
    r_src, t_src = streams
    r_rows, t_rows = r_src.materialize(), t_src.materialize()
    for a, b in ((r_rows.indices, t_rows.indices), (r_rows.values, t_rows.values),
                 (r_rows.labels, t_rows.labels)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert t_src.digest() == r_src.digest()
    with pytest.raises(ValueError, match="nnz_lo"):
        t_loop.synthetic_request_source(dim=8, num_requests=4, nnz_lo=5, nnz_hi=3)


def test_bucket_width_matches_reference():
    for min_width in (1, 4, 8):
        assert [t_batching.bucket_width(n, min_width=min_width) for n in range(130)] == \
            [r_batching.bucket_width(n, min_width=min_width) for n in range(130)]
    with pytest.raises(ValueError):
        t_batching.bucket_width(-1)


@pytest.mark.parametrize("max_batch,max_delay_s", [(8, 0.002), (64, 0.01), (4, 10.0)])
def test_batcher_flushes_like_reference_under_a_scripted_clock(streams, max_batch,
                                                               max_delay_s):
    rows = streams[1].materialize()
    idx, val = rows.indices.numpy(), rows.values.numpy()
    batchers = [m.MicroBatcher(max_batch=max_batch, max_delay_s=max_delay_s, min_width=4,
                               clock=Clock()) for m in (r_batching, t_batching)]
    flushed = [[], []]
    for r in range(idx.shape[0]):
        keep = val[r] != 0.0
        for b, out in zip(batchers, flushed):
            b.submit(idx[r, keep], val[r, keep])
            if r % 5 == 4:
                out.extend(b.ready())
    for b, out in zip(batchers, flushed):
        out.extend(b.ready() + b.drain())
    ref, port = flushed
    assert len(port) == len(ref) > 1
    for a, b in zip(ref, port):
        assert (b.shape, b.cause, b.t_flush) == (a.shape, a.cause, a.t_flush)
        assert [q.req_id for q in b.requests] == [q.req_id for q in a.requests]
        assert b.indices.tobytes() == a.indices.tobytes()
        assert b.values.tobytes() == a.values.tobytes()
    assert batchers[1].bucket_counts == batchers[0].bucket_counts
    assert batchers[1].flush_causes == batchers[0].flush_causes
    assert batchers[1].pending == 0


def test_batcher_validation():
    with pytest.raises(ValueError, match="power of two"):
        t_batching.MicroBatcher(max_batch=6)
    with pytest.raises(ValueError, match="power of two"):
        t_batching.MicroBatcher(min_width=3)
    with pytest.raises(ValueError, match="mismatch"):
        t_batching.MicroBatcher().submit([1, 2], [1.0])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_batched_margins_match_reference(streams, use_kernels, k):
    rows = streams[1].materialize()
    idx, val = rows.indices.numpy(), rows.values.numpy()
    w = np.random.default_rng(4).normal(
        size=(STREAM["dim"], k) if k > 1 else STREAM["dim"]).astype(np.float32)
    ref = r_engine.batched_margins(idx, val, w, use_kernels=False)
    port = t_engine.batched_margins(idx, val, torch.from_numpy(w), use_kernels=use_kernels,
                                    device="cpu")
    assert isinstance(port, np.ndarray) and port.shape == ref.shape
    assert np.all(np.abs(port - ref) <= MARGIN_RTOL * _scale(idx, val, w))
    if k > 1:
        for j in range(k):
            col = t_engine.batched_margins(idx, val, w[:, j].copy(),
                                           use_kernels=use_kernels, device="cpu")
            assert port[:, j].tobytes() == col.tobytes()


def test_batched_margins_refusals_and_empty_batch(w):
    idx = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="matching"):
        t_engine.batched_margins(idx, np.zeros((2, 3), np.float32), w, device="cpu")
    with pytest.raises(ValueError, match=r"\[d\] or \[d, k\]"):
        t_engine.batched_margins(idx, np.zeros((2, 4), np.float32), np.zeros((2, 2, 2)),
                                 device="cpu")
    # the kernel route takes float32 only and never falls back
    with pytest.raises(TypeError, match="float32"):
        t_engine.batched_margins(idx, np.zeros((2, 4), np.float32), w.astype(np.float64),
                                 device="cpu")
    plain64 = t_engine.batched_margins(idx, np.ones((2, 4)), w.astype(np.float64),
                                       use_kernels=False, device="cpu")
    assert plain64.dtype == np.float64
    empty = t_engine.batched_margins(np.zeros((0, 8), np.int32),
                                     np.zeros((0, 8), np.float32), w, device="cpu")
    assert empty.shape == (0,) and empty.dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_engine.batched_margins(idx, np.zeros((2, 4), np.float32), w)


def test_snapshots_copy_and_serve_like_reference(w):
    src = torch.from_numpy(w.copy())
    snap = t_engine.WeightSnapshot.from_dense(src, 0, device="cpu")
    src.add_(1.0)  # training writes w in place: the snapshot must not see it
    assert np.array_equal(snap.w.numpy(), w)
    part = r_balanced(STREAM["dim"], 3)
    blocks = [w[part.bounds[l]:part.bounds[l + 1]] for l in range(3)]
    by_blocks = t_engine.WeightSnapshot.from_blocks(blocks, 1, device="cpu")
    assert torch.equal(by_blocks.w, snap.w) and by_blocks.version == 1
    wide = t_engine.WeightSnapshot.from_dense(np.stack([w, -w], 1), 2, device="cpu")
    assert (wide.dim, wide.num_outputs) == (STREAM["dim"], 2)
    with pytest.raises(ValueError, match="at least one block"):
        t_engine.WeightSnapshot.from_blocks([], 0, device="cpu")
    with pytest.raises(ValueError, match="ndims"):
        t_engine.WeightSnapshot.from_blocks([w[:4], w[4:, None]], 0, device="cpu")
    with pytest.raises(ValueError, match=r"\[d\] or \[d, k\]"):
        t_engine.WeightSnapshot(w=torch.zeros(2, 2, 2), version=0)
    from repro_torch.api import FDSVRGClassifier

    unfitted = FDSVRGClassifier(device="cpu")
    for build in (lambda: t_engine.WeightSnapshot.from_estimator(unfitted, 0),
                  lambda: t_engine.PredictionEngine.from_estimator(unfitted)):
        with pytest.raises(ValueError, match="not fitted"):
            build()


def test_engine_publish_and_shape_meter_match_reference(w):
    engines = (r_engine.PredictionEngine(r_engine.WeightSnapshot.from_dense(w, 0)),
               t_engine.PredictionEngine(
                   t_engine.WeightSnapshot.from_dense(w, 0, device="cpu"),
                   use_kernels=False))
    shapes = [(4, 8), (4, 8), (4, 16), (8, 8), (1, 8)]
    outs = [[], []]
    for (n, width), r in zip(shapes, range(len(shapes))):
        rng = np.random.default_rng(r)
        idx = rng.integers(0, STREAM["dim"], size=(n, width)).astype(np.int32)
        val = rng.normal(size=(n, width)).astype(np.float32)
        for e, out in zip(engines, outs):
            out.append((e.margins(idx, val), _scale(idx, val, w)))
    for (a, scale), (b, _) in zip(*outs):
        assert np.all(np.abs(a - b) <= MARGIN_RTOL * scale)
    ref, port = engines
    assert len(port.compiled_shapes) == len(ref.compiled_shapes) == 4
    assert (port.batches_served, port.rows_served) == (ref.batches_served, ref.rows_served)
    assert port.version == 0
    with pytest.raises(ValueError, match="not newer"):
        port.publish(t_engine.WeightSnapshot.from_dense(w, 0, device="cpu"))
    with pytest.raises(ValueError, match="dim"):
        port.publish(t_engine.WeightSnapshot.from_dense(w[:5], 1, device="cpu"))
    prev = port.publish(t_engine.WeightSnapshot.from_dense(w, 1, device="cpu"))
    assert prev.version == 0 and port.version == 1
    with pytest.raises(ValueError, match="no snapshot"):
        t_engine.PredictionEngine().snapshot


def test_served_margin_is_the_row_scored_alone_at_its_bucket_width(streams, w):
    rows = streams[1].materialize()
    idx, val = rows.indices.numpy(), rows.values.numpy()
    engine = t_engine.PredictionEngine(t_engine.WeightSnapshot.from_dense(w, 0, device="cpu"))
    b = t_batching.MicroBatcher(max_batch=8, max_delay_s=0.0, min_width=4)
    reqs = []
    for r in range(40):
        keep = val[r] != 0.0
        reqs.append((idx[r, keep], val[r, keep]))
        b.submit(*reqs[-1])
    served = {}
    for batch in b.ready() + b.drain():
        out = engine.margins(batch.indices, batch.values)
        served.update({q.req_id: out[i] for i, q in enumerate(batch.requests)})
    for rid, (ri, rv) in enumerate(reqs):
        width = t_batching.bucket_width(len(ri), min_width=4)
        pi, pv = np.zeros((1, width), np.int32), np.zeros((1, width), np.float32)
        pi[0, :len(ri)], pv[0, :len(rv)] = ri, rv
        assert served[rid].tobytes() == engine.margins(pi, pv)[0].tobytes()


@pytest.mark.parametrize("source_kind", ["requests", "rows"])
def test_frozen_serve_loop_matches_reference(streams, w, source_kind):
    r_src, t_src = streams
    if source_kind == "rows":  # the rows of a training set, 24 wide
        from repro.data.pipeline import ArraySource as RArraySource
        from repro.data.synthetic import make_sparse_classification as r_make
        from repro_torch.data.pipeline import ArraySource as TArraySource
        from repro_torch.data.synthetic import make_sparse_classification as t_make

        kw = dict(dim=STREAM["dim"], num_instances=150, nnz_per_instance=24, seed=5)
        r_src, t_src = RArraySource(r_make(**kw)), TArraySource(t_make(**kw))
    kw = dict(max_batch=16, max_delay_s=0.002, min_width=8)
    ref = r_loop.run_serve_loop(
        r_src, r_engine.PredictionEngine(r_engine.WeightSnapshot.from_dense(w, 0)),
        r_batching.MicroBatcher(clock=Clock(), **kw), chunk_rows=32, clock=Clock())
    engine = t_engine.PredictionEngine(t_engine.WeightSnapshot.from_dense(w, 0, device="cpu"))
    port = t_loop.run_serve_loop(t_src, engine, t_batching.MicroBatcher(clock=Clock(), **kw),
                                 chunk_rows=32, clock=Clock())
    for field in ("num_batches", "versions_published", "updates_skipped", "bucket_counts",
                  "flush_causes", "compiled_shapes", "num_requests"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.compiled_shapes == len(port.bucket_counts)
    assert port.staleness_histogram() == ref.staleness_histogram() == {0: ref.num_requests}
    assert [r.req_id for r in port.served] == [r.req_id for r in ref.served]
    assert [r.latency_s for r in port.served] == [r.latency_s for r in ref.served]
    rows = t_src.materialize()
    scale = _scale(rows.indices.numpy(), rows.values.numpy(), w)
    assert np.all(np.abs(port.margins() - ref.margins()) <= MARGIN_RTOL * scale)
    assert port.latency_percentiles() == ref.latency_percentiles()
    assert port.predictions_per_s > 0


def test_serve_loop_refusals(streams, w):
    engine = t_engine.PredictionEngine(t_engine.WeightSnapshot.from_dense(w, 0, device="cpu"))
    from repro_torch.api import FDSVRGClassifier

    with pytest.raises(ValueError, match="fitted"):
        t_loop.run_serve_loop(streams[1], engine, t_batching.MicroBatcher(),
                              classifier=FDSVRGClassifier(device="cpu"))
    small = t_engine.PredictionEngine(
        t_engine.WeightSnapshot.from_dense(np.ones(7, np.float32), 0, device="cpu"))
    with pytest.raises(ValueError, match="dim"):
        t_loop.run_serve_loop(streams[1], small, t_batching.MicroBatcher())


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_engine_kernel_route_on_card(cuda_device, streams, w, k):
    from repro_torch.kernels import ops

    rows = streams[1].materialize()
    idx, val = rows.indices.numpy(), rows.values.numpy()
    wk = np.stack([w * (j + 1) for j in range(k)], 1) if k > 1 else w
    snap = t_engine.WeightSnapshot.from_dense(wk, 0, device=cuda_device)
    assert snap.w.is_cuda
    engine = t_engine.PredictionEngine(snap)
    ops.reset_launch_counts()
    got = engine.margins(idx, val)
    assert ops.launch_counts()["sparse_margin"] == k
    plain = t_engine.batched_margins(idx, val, wk, use_kernels=False, device="cpu")
    assert np.all(np.abs(got - plain) <= MARGIN_RTOL * _scale(idx, val, wk))
    if k > 1:
        for j in range(k):
            col = t_engine.batched_margins(idx, val, wk[:, j].copy(), device=cuda_device)
            assert got[:, j].tobytes() == col.tobytes()
    # each row at its own width (its stored entries) and padded to 64
    for r in range(0, 300, 7):
        keep = val[r] != 0.0
        own = t_engine.batched_margins(idx[r:r + 1, keep], val[r:r + 1, keep], wk,
                                       device=cuda_device)
        assert own.tobytes() == got[r:r + 1].tobytes()


@pytest.mark.cuda
def test_frozen_serve_loop_on_card(cuda_device, streams, w):
    engine = t_engine.PredictionEngine(t_engine.WeightSnapshot.from_dense(w, 0,
                                                                          device=cuda_device))
    report = t_loop.run_serve_loop(streams[1], engine,
                                   t_batching.MicroBatcher(max_batch=32, min_width=8),
                                   chunk_rows=32)
    rows = streams[1].materialize()
    plain = t_engine.batched_margins(rows.indices.numpy(), rows.values.numpy(), w,
                                     use_kernels=False, device="cpu")
    scale = _scale(rows.indices.numpy(), rows.values.numpy(), w)
    assert np.all(np.abs(report.margins() - plain) <= MARGIN_RTOL * scale)
    assert report.compiled_shapes == len(report.bucket_counts)
    assert dataclasses.is_dataclass(report) and report.num_requests == STREAM["num_requests"]


if __name__ == "__main__":
    r_src, t_src = (r_loop.synthetic_request_source(**STREAM),
                    t_loop.synthetic_request_source(**STREAM))
    rows = t_src.materialize()
    w0 = np.random.default_rng(3).normal(size=STREAM["dim"]).astype(np.float32)
    idx, val = rows.indices.numpy(), rows.values.numpy()
    ref = r_engine.batched_margins(idx, val, w0)
    port = t_engine.batched_margins(idx, val, w0, device="cpu")
    print("batched_margins: worst |d| / sum|w x| =",
          float(np.max(np.abs(port - ref) / _scale(idx, val, w0))), "tolerance", MARGIN_RTOL)
