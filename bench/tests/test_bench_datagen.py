"""The generator repeats from a seed, and its rows have the stated shape."""

import torch

from bench import datagen

BIG_SEED = 2**31 + 12345  # past 32 signed bits, as the benchmark's seeds are


def _draw(seed):
    return datagen.make_sparse(dim=997, num_instances=64, nnz_per_instance=16, seed=seed,
                               device="cpu")


def test_same_seed_same_bytes():
    a, b = _draw(BIG_SEED), _draw(BIG_SEED)
    assert torch.equal(a.indices, b.indices)
    assert torch.equal(a.values.view(torch.int32), b.values.view(torch.int32))
    assert torch.equal(a.labels, b.labels)
    assert a.fingerprint() == b.fingerprint()


def test_other_seed_other_rows():
    assert not torch.equal(_draw(BIG_SEED).indices, _draw(BIG_SEED + 1).indices)


def test_rows_as_stated():
    d = _draw(7)
    assert d.indices.dtype == torch.int32 and d.values.dtype == torch.float32
    assert tuple(d.indices.shape) == (64, 16) and d.dim == 997
    assert int(d.indices.min()) >= 0 and int(d.indices.max()) < 997
    assert torch.all(d.values > 0)
    norms = torch.linalg.vector_norm(d.values, dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    assert set(d.labels.tolist()) <= {-1.0, 1.0}
