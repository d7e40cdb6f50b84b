"""The port's streaming LibSVM ingestion (``repro_torch.data.libsvm``,
``repro_torch.data.pipeline``, ``repro_torch.data.ingest_cache``) held
against the reference's (``repro.data.*``), on the CPU.

Tolerances: everything the ingestion builds is held byte for byte (the
parsed arrays, the label mapping, the error class and message, the
digests, every slab's indices, values and ``nnz_col``, the cache files
read across packages).  ``streamed_margins`` is a float reduction that
the port runs in PyTorch and the reference in NumPy's ``einsum``: held
within ``MARGIN_RTOL`` of the sum of ``|w[idx] * val|`` per row (float32)
and ``1e-12`` of it (float64); the multi-output columns are bit for bit
the port's scalar passes.  The ``cuda``-marked cases hold the margin
kernel's route against the plain route on the card within
``MARGIN_RTOL``.
"""

import os

import numpy as np
import pytest
import torch

from repro.core.partition import balanced as r_balanced
from repro.data import ingest_cache as r_cache
from repro.data import libsvm as r_libsvm
from repro.data import pipeline as r_pipe
from repro.data.block_csr import BlockCSR as RBlockCSR
from repro.data.synthetic import make_sparse_classification as r_make

from repro_torch.core.partition import balanced as t_balanced
from repro_torch.data import datasets as t_datasets
from repro_torch.data import ingest_cache as t_cache
from repro_torch.data import libsvm as t_libsvm
from repro_torch.data import pipeline as t_pipe
from repro_torch.data.block_csr import BlockCSR as TBlockCSR
from repro_torch.data.sparse import PaddedCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make

MARGIN_RTOL = 1e-6
DATA = dict(dim=3000, num_instances=61, nnz_per_instance=24, seed=4)

# Comments, a qid token, explicit zeros, duplicate ids in file order, a
# blank line and a label-only row; the labels are filled in per alphabet.
TEXT = """# a header comment
{a} 3:0.5 1:1.25 3:-2 # trailing comment
{b} qid:7 2:0 5:3.5

{b}
{a} 4:1e-3 4:2.0 1:0 9:-0.75
{b} 7:1 2:0.1
"""
ALPHABETS = {"pm1": ("+1", "-1"), "01": ("1", "0"), "12": ("2", "1")}
MALFORMED = ["1 a:3\n", "x 1:2\n", "1 0:5\n", "1 3\n", "1 3:abc\n", "-1 2:1 :4\n"]


def _write(tmp_path, text, name="data.svm"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _same_padded(r, t):
    assert r.dim == t.dim
    assert _bytes(r.indices) == _bytes(t.indices)
    assert _bytes(r.values) == _bytes(t.values)
    assert _bytes(r.labels) == _bytes(t.labels)
    assert t.indices.dtype == torch.int32 and t.values.dtype == torch.float32


def _same_block_csr(t, other):
    """Every slab's indices, values and nnz_col byte for byte, the labels,
    dim and nnz_max; ``other`` is a port or a reference BlockCSR."""
    assert t.num_blocks == other.num_blocks and t.dim == other.dim
    assert t.global_nnz_max() == other.global_nnz_max()
    assert _bytes(t.labels) == _bytes(other.labels)
    for l in range(t.num_blocks):
        assert _bytes(t.indices[l]) == _bytes(other.indices[l])
        assert _bytes(t.values[l]) == _bytes(other.values[l])
        assert _bytes(t.nnz_col_block(l)) == _bytes(other.nnz_col_block(l))


@pytest.fixture(scope="module")
def rows():
    return r_make(**DATA), t_make(**DATA)


@pytest.fixture(scope="module")
def svm_file(tmp_path_factory, rows):
    path = str(tmp_path_factory.mktemp("svm") / "rows.svm")
    t_libsvm.write_libsvm(path, rows[1], comment="synthetic rows")
    return path


# ---------------------------------------------------------------------------
# the text layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alphabet", list(ALPHABETS))
def test_load_libsvm_matches_reference(tmp_path, alphabet):
    a, b = ALPHABETS[alphabet]
    path = _write(tmp_path, TEXT.format(a=a, b=b))
    ref, port = r_libsvm.load_libsvm(path), t_libsvm.load_libsvm(path)
    _same_padded(ref, port)
    assert port.labels.tolist() == [1.0, -1.0, -1.0, 1.0, -1.0]
    # duplicates in file order, explicit zeros stored, qid skipped
    assert port.indices[0, :3].tolist() == [2, 0, 2]
    assert port.values[1, :2].tolist() == [0.0, 3.5]
    assert port.indices[3, :4].tolist() == [3, 3, 0, 8]
    assert t_libsvm.scan_libsvm(path) == \
        t_libsvm.LibSVMStats(**vars(r_libsvm.scan_libsvm(path)))
    _same_padded(r_libsvm.load_libsvm(path, dim=20, chunk_rows=2),
                 t_libsvm.load_libsvm(path, dim=20, chunk_rows=2))


@pytest.mark.parametrize("line", MALFORMED)
def test_malformed_text_raises_like_reference(tmp_path, line):
    path = _write(tmp_path, "1 1:1\n" + line)
    with pytest.raises(ValueError) as ref_err:
        r_libsvm.load_libsvm(path)
    with pytest.raises(ValueError) as port_err:
        t_libsvm.load_libsvm(path)
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert str(port_err.value) == str(ref_err.value)
    assert isinstance(port_err.value, t_libsvm.LibSVMFormatError)


def test_label_rules_and_dim_errors_match_reference(tmp_path):
    for values in [(-1.0, 1.0), (0.0, 1.0), (3.0, 7.0), (1.0,), (-1.0,)]:
        raw = np.array(values * 2)
        assert np.array_equal(r_libsvm.canonical_label_map(values)(raw),
                              t_libsvm.canonical_label_map(values)(raw))
    for values in [(1.0, 2.0, 3.0), (5.0,), ()]:
        with pytest.raises(ValueError) as ref_err:
            r_libsvm.canonical_label_map(values)
        with pytest.raises(ValueError, match="label") as port_err:
            t_libsvm.canonical_label_map(values)
        assert str(port_err.value) == str(ref_err.value)
    path = _write(tmp_path, TEXT.format(a="1", b="-1"))
    with pytest.raises(ValueError) as ref_err:
        r_libsvm.load_libsvm(path, dim=5)
    with pytest.raises(ValueError, match="dim=5") as port_err:
        t_libsvm.load_libsvm(path, dim=5)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError) as ref_err:
        r_pipe.LibSVMSource(path, dim=5).stats()
    with pytest.raises(ValueError, match="dim=5") as port_err:
        t_pipe.LibSVMSource(path, dim=5).stats()
    assert str(port_err.value) == str(ref_err.value)


def test_write_libsvm_text_and_round_trip_match_reference(tmp_path, rows):
    r_path = r_libsvm.write_libsvm(str(tmp_path / "r.svm"), rows[0], comment="x")
    t_path = t_libsvm.write_libsvm(str(tmp_path / "t.svm"), rows[1], comment="x")
    with open(r_path, "rb") as fr, open(t_path, "rb") as ft:
        assert fr.read() == ft.read()
    _same_padded(rows[0], t_libsvm.load_libsvm(t_path))


# ---------------------------------------------------------------------------
# sources and the streamed build
# ---------------------------------------------------------------------------


def test_digests_match_reference(rows, svm_file):
    r_rows, t_rows = rows
    assert t_pipe.ArraySource(t_rows).digest() == r_pipe.ArraySource(r_rows).digest()
    assert t_pipe.LibSVMSource(svm_file).digest() == r_pipe.LibSVMSource(svm_file).digest()
    assert t_pipe.LibSVMSource(svm_file, dim=DATA["dim"]).digest() == \
        r_pipe.LibSVMSource(svm_file, dim=DATA["dim"]).digest()
    kw = dict(dim=DATA["dim"], num_instances=DATA["num_instances"],
              nnz_per_instance=DATA["nnz_per_instance"], seed=DATA["seed"])
    assert t_pipe.SyntheticSource(**kw).digest() == r_pipe.SyntheticSource(**kw).digest()
    src = t_pipe.SyntheticSource.from_dataset("news20", seed=1)
    ref = r_pipe.SyntheticSource.from_dataset("news20", seed=1)
    assert src.digest() == ref.digest() and src.name == ref.name
    assert t_pipe.SourceStats(**vars(ref.stats())) == src.stats()


@pytest.mark.parametrize("lane_multiple", [1, 8])
@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("chunk_rows", [1, 7, DATA["num_instances"]])
def test_stream_block_csr_matches_from_padded_and_reference(svm_file, chunk_rows, q,
                                                            lane_multiple):
    dim = DATA["dim"]
    port = t_pipe.stream_block_csr(t_pipe.LibSVMSource(svm_file, dim=dim),
                                   t_balanced(dim, q), chunk_rows=chunk_rows,
                                   lane_multiple=lane_multiple)
    one_shot = TBlockCSR.from_padded(t_libsvm.load_libsvm(svm_file, dim=dim),
                                     t_balanced(dim, q), lane_multiple=lane_multiple)
    ref = r_pipe.stream_block_csr(r_pipe.LibSVMSource(svm_file, dim=dim),
                                  r_balanced(dim, q), chunk_rows=chunk_rows,
                                  lane_multiple=lane_multiple)
    _same_block_csr(port, one_shot)
    _same_block_csr(port, ref)
    assert port.device == torch.device("cpu") and not port._block_rows
    assert not port._snapshot_index


@pytest.mark.parametrize("q", [1, 3])
def test_stream_block_slab_and_array_source_match(rows, q):
    r_rows, t_rows = rows
    part = t_balanced(t_rows.dim, q)
    full = t_pipe.stream_block_csr(t_pipe.ArraySource(t_rows), part, chunk_rows=5)
    _same_block_csr(full, TBlockCSR.from_padded(t_rows, part))
    for l in range(q):
        slab = t_pipe.stream_block_slab(t_pipe.ArraySource(t_rows), part, l, chunk_rows=9)
        ref = r_pipe.stream_block_slab(r_pipe.ArraySource(r_rows),
                                       r_balanced(r_rows.dim, q), l, chunk_rows=9)
        for got, want, mine in zip(slab, ref, (full.indices[l], full.values[l],
                                               full.nnz_col_block(l))):
            assert _bytes(got) == _bytes(want) == _bytes(mine)
    assert np.array_equal(t_pipe.source_labels(t_pipe.ArraySource(t_rows), chunk_rows=4),
                          r_pipe.source_labels(r_pipe.ArraySource(r_rows), chunk_rows=4))


def test_materialize_and_as_source(rows, svm_file):
    r_rows, t_rows = rows
    _same_padded(r_pipe.LibSVMSource(svm_file).materialize(),
                 t_pipe.LibSVMSource(svm_file).materialize())
    assert isinstance(t_pipe.as_source(svm_file), t_pipe.LibSVMSource)
    assert isinstance(t_pipe.as_source(t_rows), t_pipe.ArraySource)
    with pytest.raises(TypeError, match="DataSource"):
        t_pipe.as_source(3)


def test_datasets_guard_points_at_the_streaming_source():
    with pytest.raises(MemoryError, match=r"SyntheticSource\.from_dataset\('url'"):
        t_datasets.load("url", scaled=False)


# ---------------------------------------------------------------------------
# the slab cache, across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_loads_the_others_cache(tmp_path, svm_file, writer):
    q, lane = 3, 8
    cache_dir = str(tmp_path / "cache")
    port_src, ref_src = t_pipe.LibSVMSource(svm_file), r_pipe.LibSVMSource(svm_file)
    dim = port_src.stats().dim
    t_part, r_part = t_balanced(dim, q), r_balanced(dim, q)
    assert t_cache.cache_key(port_src.digest(), t_part, lane) == \
        r_cache.cache_key(ref_src.digest(), r_part, lane)
    if writer == "port":
        first = t_cache.get_or_build(port_src, t_part, cache_dir=cache_dir, lane_multiple=lane)
        second = r_cache.get_or_build(ref_src, r_part, cache_dir=cache_dir, lane_multiple=lane)
    else:
        first = r_cache.get_or_build(ref_src, r_part, cache_dir=cache_dir, lane_multiple=lane)
        second = t_cache.get_or_build(port_src, t_part, cache_dir=cache_dir, lane_multiple=lane)
    assert (first.status, second.status) == ("cold", "warm")
    assert first.path == second.path
    port = first.data if writer == "port" else second.data
    ref = second.data if writer == "port" else first.data
    _same_block_csr(port, ref)
    assert isinstance(port, TBlockCSR) and isinstance(ref, RBlockCSR)
    again = t_cache.get_or_build(port_src, t_part, cache_dir=cache_dir, lane_multiple=lane)
    assert again.status == "warm"
    _same_block_csr(again.data, port)
    off = t_cache.get_or_build(port_src, t_part, cache_dir=None, lane_multiple=lane)
    assert off.status == "off" and off.path is None
    _same_block_csr(off.data, port)


# ---------------------------------------------------------------------------
# streamed margins
# ---------------------------------------------------------------------------


def _margin_scale(rows, w):
    idx, val = np.asarray(rows.indices), np.asarray(rows.values, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 2:
        return np.abs(w[idx] * val[..., None]).sum(axis=1)
    return np.abs(w[idx] * val).sum(axis=1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3])
def test_streamed_margins_match_reference(rows, dtype, k):
    r_rows, t_rows = rows
    rng = np.random.default_rng(8)
    w = rng.normal(size=(DATA["dim"], k) if k > 1 else DATA["dim"]).astype(dtype)
    ref = r_pipe.streamed_margins(r_pipe.ArraySource(r_rows), w, chunk_rows=13)
    # float64 w runs the plain route (the kernel takes float32 only).
    use_kernels = dtype == np.float32
    port = t_pipe.streamed_margins(t_pipe.ArraySource(t_rows), torch.from_numpy(w),
                                   chunk_rows=13, use_kernels=use_kernels, device="cpu")
    assert port.dtype == ref.dtype and port.shape == ref.shape
    rtol = MARGIN_RTOL if dtype == np.float32 else 1e-12
    assert np.all(np.abs(port - ref) <= rtol * _margin_scale(t_rows, w))
    if k > 1:
        for j in range(k):
            col = t_pipe.streamed_margins(t_pipe.ArraySource(t_rows),
                                          torch.from_numpy(w[:, j].copy()), chunk_rows=13,
                                          use_kernels=use_kernels, device="cpu")
            assert _bytes(port[:, j].copy()) == _bytes(col)
    with pytest.raises(TypeError, match="float32"):
        t_pipe.streamed_margins(t_pipe.ArraySource(t_rows), torch.zeros(DATA["dim"],
                                dtype=torch.float64), device="cpu")


def test_streamed_margins_over_a_file_and_an_empty_source(rows, svm_file):
    w = np.random.default_rng(9).normal(size=DATA["dim"]).astype(np.float32)
    port = t_pipe.streamed_margins(t_pipe.LibSVMSource(svm_file, dim=DATA["dim"]), w,
                                   chunk_rows=16, device="cpu")
    ref = r_pipe.streamed_margins(r_pipe.LibSVMSource(svm_file, dim=DATA["dim"]), w,
                                  chunk_rows=16)
    assert np.all(np.abs(port - ref) <= MARGIN_RTOL * _margin_scale(rows[1], w))
    empty = t_pipe.ArraySource(PaddedCSR(
        indices=torch.zeros((0, 4), dtype=torch.int32), values=torch.zeros((0, 4)),
        labels=torch.zeros(0), dim=DATA["dim"]))
    assert t_pipe.streamed_margins(empty, w, device="cpu").shape == (0,)
    assert t_pipe.streamed_margins(empty, w[:, None], device="cpu").shape == (0, 1)


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_streamed_margins_kernel_route_on_card(cuda_device, rows, svm_file, k):
    from repro_torch.kernels import ops

    t_rows = rows[1]
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.normal(size=(DATA["dim"], k) if k > 1 else DATA["dim"])
                         .astype(np.float32))
    src = t_pipe.LibSVMSource(svm_file, dim=DATA["dim"])
    ops.reset_launch_counts()
    got = t_pipe.streamed_margins(src, w, chunk_rows=16, device=cuda_device)
    chunks = -(-DATA["num_instances"] // 16)
    assert ops.launch_counts()["sparse_margin"] == chunks * k
    plain = t_pipe.streamed_margins(src, w, chunk_rows=16, use_kernels=False,
                                    device=cuda_device)
    assert np.all(np.abs(got - plain) <= MARGIN_RTOL * _margin_scale(t_rows, w.numpy()))
    again = t_pipe.streamed_margins(src, w, chunk_rows=16, device=cuda_device)
    assert _bytes(got) == _bytes(again)


if __name__ == "__main__":
    rr, tr = r_make(**DATA), t_make(**DATA)
    w = np.random.default_rng(8).normal(size=DATA["dim"]).astype(np.float32)
    ref = r_pipe.streamed_margins(r_pipe.ArraySource(rr), w, chunk_rows=13)
    port = t_pipe.streamed_margins(t_pipe.ArraySource(tr), w, chunk_rows=13, device="cpu")
    print("streamed_margins f32: worst |d| / sum|w x| =",
          float(np.max(np.abs(port - ref) / _margin_scale(tr, w))), "tolerance", MARGIN_RTOL)
    print(os.path.basename(__file__), "ok")
