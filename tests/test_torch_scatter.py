"""The snapshot scatter: its flat-order index, its plain version and its kernel.

``ops.snapshot_scatter`` computes ``local_scatter``'s function for all q
blocks of a ``BlockCSR`` at once (one kernel launch on the card), the
blocks' z concatenated, each id's terms ``values[p] * coeffs[p // nnz_l]``
added from +0.0 in increasing flat position ``p``; ``block_scatter`` over
a ``scatter_index`` is the kernel's one-block case.  On the CPU that is what ``index_add_`` and the
reference's ``.at[].add`` do, so the stated tolerance here is none: the
fold in the index's order, the port's ``local_scatter`` and the
reference's ``repro.data.block_csr.local_scatter`` agree bit for bit, on
rows with about 80 copies of one id (as the news20 generator leaves them),
with padding (local id 0, value 0.0), explicit zeros and negative
coefficients (whose padding terms are -0.0).  The CUDA kernel compiles only
on the card: the tests marked ``cuda`` hold it bitwise against the CPU
there and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.block_csr import local_scatter as r_local_scatter

from repro_torch.core import losses
from repro_torch.core.fdsvrg import _full_grad_blocks
from repro_torch.core.partition import balanced
from repro_torch.data.block_csr import BlockCSR, local_scatter
from repro_torch.data.synthetic import make_sparse_classification
from repro_torch.kernels import block_scatter as scatter_mod
from repro_torch.kernels import ops

# (seed, rows, nnz_l, dim, copies of the hot id per row, padding per row)
CASES = [
    (0, 64, 24, 500, 0, 3),
    (1, 200, 96, 3000, 80, 5),  # ~80 copies of one id in every row, as news20's block 0
    (2, 33, 7, 5, 0, 0),  # more terms than ids: every id repeats
    (3, 16, 12, 40_000, 0, 12),  # all padding: z is +0.0 everywhere
    (4, 60, 90, 1000, 85, 1),  # 5,100 copies: a heavy id, over one staged tile
]


def _case(seed, rows, width, dim, hot, pad):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(rows, width)).astype(np.int32)
    val = rng.normal(size=(rows, width)).astype(np.float32)
    idx[:, :hot] = dim // 3
    val[rng.random((rows, width)) < 0.05] = 0.0  # explicit zeros inside the rows
    idx[:, width - pad:] = 0
    val[:, width - pad:] = 0.0
    coef = (rng.normal(size=rows) * 1e-2).astype(np.float32)  # both signs
    return idx, val, coef


def _blocks(q, seed=7, rows=60):
    """q blocks of rows over shared coefficients: block l has width 9 + 5l,
    dim 40 + 97l, and (l % 3) * 30 copies of its hot id a row, so the heavy
    ids (1,800 and 3,600 terms) lie in several blocks; padding and explicit
    zeros everywhere."""
    idx, val = [], []
    for l in range(q):
        i, v, coef = _case(seed + l, rows, 9 + 5 * l + (l % 3) * 30, 40 + 97 * l, (l % 3) * 30,
                           1 + l % 2)
        idx.append(torch.from_numpy(i))
        val.append(torch.from_numpy(v))
        coef0 = coef if l == 0 else coef0
    return idx, val, torch.from_numpy(coef0), [40 + 97 * l for l in range(q)]


def _fold(values, coeffs, index, dim):
    """The kernel's arithmetic in PyTorch: each id's terms in index order,
    one float32 add at a time, from +0.0.  ``values`` is one block's rows
    or a sequence of the index's blocks."""
    blocks = [values] if isinstance(values, torch.Tensor) else list(values)
    perm, starts, bounds = index.perm.long(), index.starts.long(), index.bounds.long()
    terms = torch.zeros(perm.shape, dtype=torch.float32)
    for l, val in enumerate(blocks):
        seg = slice(int(starts[bounds[l]]), int(starts[bounds[l + 1]]))
        terms[seg] = val.reshape(-1)[perm[seg]] * coeffs[perm[seg] // val.shape[1]]
    counts = starts[1:] - starts[:-1]
    z = torch.zeros(dim, dtype=torch.float32)
    for j in range(int(counts.max()) if counts.numel() else 0):
        have = counts > j
        z[have] = z[have] + terms[starts[:-1][have] + j]
    return z


@pytest.mark.parametrize("case", CASES)
def test_scatter_index_lists_each_nonzero_entry_once_in_flat_order(case):
    idx, val, _ = _case(*case)
    dim = case[3]
    index = scatter_mod.scatter_index(torch.from_numpy(idx), torch.from_numpy(val), dim)
    perm, starts, heavy, bounds = (t.numpy() for t in index[:4])
    assert perm.dtype == heavy.dtype == bounds.dtype == np.int32 and starts.dtype == np.int64
    assert index.shapes == (idx.shape,) and bounds.tolist() == [0, dim]
    assert starts.shape == (dim + 1,) and starts[0] == 0 and starts[-1] == perm.size
    assert np.all(np.diff(starts) >= 0)  # monotone
    nonzero = np.flatnonzero(val.reshape(-1) != 0)
    assert np.array_equal(np.sort(perm), nonzero)  # every nonzero entry once, no zero
    flat_ids = idx.reshape(-1)
    counts = np.diff(starts)
    for i in np.flatnonzero(counts):
        run = perm[starts[i]:starts[i + 1]]
        assert np.all(flat_ids[run] == i) and np.all(np.diff(run) > 0)  # increasing p
    assert np.array_equal(counts, np.bincount(flat_ids[nonzero], minlength=dim))
    assert np.all(counts[heavy] > scatter_mod.HEAVY_MIN)
    assert np.array_equal(np.sort(heavy), np.flatnonzero(counts > scatter_mod.HEAVY_MIN))
    assert np.all(np.diff(counts[heavy]) <= 0)  # longest first


@pytest.mark.parametrize("case", CASES)
def test_flat_order_fold_equals_local_scatter_and_reference_bitwise(case):
    idx, val, coef = _case(*case)
    dim = case[3]
    ti, tv, tc = (torch.from_numpy(a) for a in (idx, val, coef))
    index = scatter_mod.scatter_index(ti, tv, dim)
    got = _fold(tv, tc, index, dim)
    plain = local_scatter(ti, tv, tc, dim)
    ref = np.asarray(r_local_scatter(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(coef), dim))
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))  # -0.0 too
    assert torch.equal(scatter_mod.block_scatter_plain(ti, tv, tc, dim), plain)
    assert not torch.any(torch.signbit(got) & (got == 0))  # never -0.0


def test_block_scatter_kernel_refuses_cpu_tensors():
    idx, val, coef = (torch.from_numpy(a) for a in _case(*CASES[0]))
    index = scatter_mod.scatter_index(idx, val, CASES[0][3])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        scatter_mod.block_scatter(val, coef, index)


def _one_block(idx, val, dim):
    """A one-block ``BlockCSR`` over the rows of a case."""
    return BlockCSR(partition=balanced(dim, 1), indices=(idx,), values=(val,),
                    labels=torch.ones(idx.shape[0]), dim=dim)


def test_ops_block_scatter_routes_cpu_tensors_to_the_plain_version():
    """ops' scatter entry, at q = 1 one block's scatter, on CPU tensors."""
    idx, val, coef = (torch.from_numpy(a) for a in _case(*CASES[1]))
    dim = CASES[1][3]
    bd = _one_block(idx, val, dim)
    ops.reset_launch_counts()
    got = ops.snapshot_scatter(bd, coef)
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert torch.equal(got, local_scatter(idx, val, coef, dim))
    assert torch.equal(got, _fold(val, coef, scatter_mod.scatter_index(idx, val, dim), dim))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.snapshot_scatter(bd, coef.to("meta"))


def test_blockcsr_builds_each_scatter_index_once_and_snapshots_agree():
    data = make_sparse_classification(dim=2000, num_instances=120, nnz_per_instance=15, seed=3)
    part = balanced(2000, 3)
    bd = BlockCSR.from_padded(data, part)
    first = bd.snapshot_index()
    assert bd.to("cpu").snapshot_index() is first  # kept across .to() copies
    assert bd.snapshot_index() is first
    w = torch.from_numpy(np.random.default_rng(0).normal(size=2000).astype(np.float32))
    loss = losses.LOSSES["logistic"]
    z_k, s_k = _full_grad_blocks(bd, w, loss, True)
    z_p, s_p = _full_grad_blocks(bd, w, loss, False)
    assert torch.equal(z_k, z_p) and torch.equal(s_k, s_p)


QS = [1, 3, 8]


@pytest.mark.parametrize("q", QS)
def test_snapshot_index_lists_each_entry_once_with_heavy_ids_longest_first(q):
    idx, val, _, dims = _blocks(q)
    index = scatter_mod.snapshot_index(idx, val, dims)
    perm, starts, heavy, bounds = (t.numpy() for t in index[:4])
    assert index.shapes == tuple(tuple(v.shape) for v in val)
    assert bounds.tolist() == np.concatenate([[0], np.cumsum(dims)]).tolist()
    assert starts.dtype == np.int64 and starts[0] == 0 and starts[-1] == perm.size
    for l in range(q):
        ids = starts[bounds[l]:bounds[l + 1] + 1]
        seg = perm[ids[0]:ids[-1]]
        flat_ids, flat_val = idx[l].numpy().reshape(-1), val[l].numpy().reshape(-1)
        # every nonzero entry of block l once, in its own block's segment
        assert np.array_equal(np.sort(seg), np.flatnonzero(flat_val != 0))
        counts = np.diff(ids)
        for i in np.flatnonzero(counts):
            run = perm[ids[i]:ids[i + 1]]
            assert np.all(flat_ids[run] == i) and np.all(np.diff(run) > 0)  # flat order
    counts = np.diff(starts)
    assert np.array_equal(np.sort(heavy), np.flatnonzero(counts > scatter_mod.HEAVY_MIN))
    assert np.all(np.diff(counts[heavy]) <= 0)  # longest first, across blocks
    owners = [int(np.searchsorted(bounds, h, side="right")) - 1 for h in heavy]
    assert set(owners) == {l for l in range(q) if l % 3}  # heavy ids in several blocks
    assert q < 3 or owners[0] == 2  # block 2's 3,600-term id before block 1's 1,800


@pytest.mark.parametrize("heavy_min", [1, 50, 1799, 1800, 10_000])
def test_snapshot_index_carries_the_heavy_min_it_listed_heavy_ids_by(heavy_min):
    """The launch reads heavy_min from the index, so the ids the light
    threads leave out are exactly the ones the heavy list holds."""
    idx, val, _, dims = _blocks(3)
    index = scatter_mod.snapshot_index(idx, val, dims, heavy_min=heavy_min)
    counts = np.diff(index.starts.numpy())
    assert index.heavy_min == heavy_min
    assert np.array_equal(np.sort(index.heavy.numpy()), np.flatnonzero(counts > heavy_min))
    one = scatter_mod.scatter_index(idx[1], val[1], dims[1], heavy_min)
    assert one.heavy_min == heavy_min
    assert scatter_mod.snapshot_index(idx, val, dims).heavy_min == scatter_mod.HEAVY_MIN
    with pytest.raises(ValueError, match="heavy_min"):
        scatter_mod.snapshot_index(idx, val, dims, heavy_min=0)


@pytest.mark.parametrize("q", QS)
def test_snapshot_fold_equals_concatenated_local_scatter_and_reference_bitwise(q):
    idx, val, coef, dims = _blocks(q)
    index = scatter_mod.snapshot_index(idx, val, dims)
    got = _fold(val, coef, index, sum(dims))
    plain = torch.cat([local_scatter(i, v, coef, d) for i, v, d in zip(idx, val, dims)])
    ref = np.concatenate([
        np.asarray(r_local_scatter(jnp.asarray(i.numpy()), jnp.asarray(v.numpy()),
                                   jnp.asarray(coef.numpy()), d))
        for i, v, d in zip(idx, val, dims)
    ])
    assert np.array_equal(got.numpy().view(np.int32), plain.numpy().view(np.int32))
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def _blockcsr(q):
    data = make_sparse_classification(dim=2000, num_instances=120, nnz_per_instance=15, seed=q)
    return BlockCSR.from_padded(data, balanced(2000, q))


@pytest.mark.parametrize("q", QS)
def test_ops_snapshot_scatter_on_cpu_equals_the_per_block_plain_cat(q):
    bd = _blockcsr(q)
    coef = torch.from_numpy(np.random.default_rng(q).normal(size=120).astype(np.float32))
    ops.reset_launch_counts()
    got = ops.snapshot_scatter(bd, coef)
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    want = torch.cat([scatter_mod.block_scatter_plain(*bd.block(l), coef, bd.block_dims[l])
                      for l in range(q)])
    assert got.shape == (2000,) and np.array_equal(got.numpy().view(np.int32),
                                                   want.numpy().view(np.int32))
    assert torch.equal(got, _fold(bd.values, coef, bd.snapshot_index(), 2000))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.snapshot_scatter(bd, coef.to("meta"))


def test_blockcsr_builds_the_snapshot_index_once_per_device():
    bd = _blockcsr(3)
    first = bd.snapshot_index()
    assert bd.snapshot_index() is first and bd.to("cpu").snapshot_index() is first
    assert list(bd._snapshot_index) == ["cpu"]
    other = _blockcsr(3)  # an equal layout built anew has its own cache
    assert other.snapshot_index() is not first
    assert all(torch.equal(a, b) for a, b in zip(other.snapshot_index()[:4], first[:4]))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        scatter_mod.block_scatter(bd.values, torch.zeros(120), first)


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_block_scatter_kernel_equals_cpu_bitwise_twice_on_card(cuda_device, case):
    idx, val, coef = (torch.from_numpy(a) for a in _case(*case))
    dim = case[3]
    want = local_scatter(idx, val, coef, dim)
    di, dv, dc = (t.to(cuda_device) for t in (idx, val, coef))
    index = scatter_mod.scatter_index(di, dv, dim)
    before = scatter_mod.launches
    for _ in range(2):
        got = scatter_mod.block_scatter(dv, dc, index)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))
    assert scatter_mod.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("q", QS)
def test_snapshot_scatter_kernel_equals_cpu_bitwise_twice_on_card(cuda_device, q):
    """One launch for all q blocks, bitwise the CPU's per-block index_add_,
    twice; the heavy folds' timing buffer holds ordered clock readings."""
    idx, val, coef, dims = _blocks(q)
    want = torch.cat([local_scatter(i, v, coef, d) for i, v, d in zip(idx, val, dims)])
    dv = [v.to(cuda_device) for v in val]
    dc = coef.to(cuda_device)
    index = scatter_mod.snapshot_index([i.to(cuda_device) for i in idx], dv, dims)
    before = scatter_mod.launches
    for _ in range(2):
        got = scatter_mod.block_scatter(dv, dc, index)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))
    assert scatter_mod.launches == before + 2
    timing = torch.zeros(2 * index.heavy.numel(), dtype=torch.int64, device=cuda_device)
    got = scatter_mod.block_scatter(dv, dc, index, timing)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    t = timing.cpu().reshape(-1, 2)
    assert bool(torch.all(t[:, 1] >= t[:, 0])) and bool(torch.all(t[:, 0] > 0))


@pytest.mark.cuda
def test_ops_snapshot_scatter_launches_once_for_q_blocks_on_card(cuda_device):
    bd = _blockcsr(8).to(cuda_device)
    coef = torch.from_numpy(np.random.default_rng(0).normal(size=120).astype(np.float32))
    ops.reset_launch_counts()
    got = ops.snapshot_scatter(bd, coef.to(cuda_device))
    assert ops.launch_counts()["block_scatter"] == 1
    want = ops.snapshot_scatter(_blockcsr(8), coef)
    assert np.array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))
