"""The snapshot scatter: its flat-order index, its plain version and its kernel.

``ops.block_scatter`` computes ``local_scatter``'s function, each id's
terms ``values[p] * coeffs[p // nnz_l]`` added from +0.0 in increasing
flat position ``p``.  On the CPU that is what ``index_add_`` and the
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


def _fold(values, coeffs, index, dim):
    """The kernel's arithmetic in PyTorch: each id's terms in index order,
    one float32 add at a time, from +0.0."""
    perm, starts = index.perm.long(), index.starts.long()
    terms = values.reshape(-1)[perm] * coeffs[perm // values.shape[1]]
    counts = starts[1:] - starts[:-1]
    z = torch.zeros(dim, dtype=values.dtype)
    for j in range(int(counts.max()) if counts.numel() else 0):
        have = counts > j
        z[have] = z[have] + terms[starts[:-1][have] + j]
    return z


@pytest.mark.parametrize("case", CASES)
def test_scatter_index_lists_each_nonzero_entry_once_in_flat_order(case):
    idx, val, _ = _case(*case)
    dim = case[3]
    index = scatter_mod.scatter_index(torch.from_numpy(idx), torch.from_numpy(val), dim)
    perm, starts, heavy = (t.numpy() for t in index)
    assert perm.dtype == starts.dtype == heavy.dtype == np.int32
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


def test_ops_block_scatter_routes_cpu_tensors_to_the_plain_version():
    idx, val, coef = (torch.from_numpy(a) for a in _case(*CASES[1]))
    dim = CASES[1][3]
    index = scatter_mod.scatter_index(idx, val, dim)
    ops.reset_launch_counts()
    got = ops.block_scatter(idx, val, coef, dim, index)
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert torch.equal(got, local_scatter(idx, val, coef, dim))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.block_scatter(idx, val.to("meta"), coef, dim, index)


def test_blockcsr_builds_each_scatter_index_once_and_snapshots_agree():
    data = make_sparse_classification(dim=2000, num_instances=120, nnz_per_instance=15, seed=3)
    part = balanced(2000, 3)
    bd = BlockCSR.from_padded(data, part)
    first = bd.scatter_index(1)
    assert bd.to("cpu").scatter_index(1) is first  # kept across .to() copies
    assert bd.scatter_index(0) is not first
    w = torch.from_numpy(np.random.default_rng(0).normal(size=2000).astype(np.float32))
    loss = losses.LOSSES["logistic"]
    z_k, s_k = _full_grad_blocks(bd, w, loss, True)
    z_p, s_p = _full_grad_blocks(bd, w, loss, False)
    assert torch.equal(z_k, z_p) and torch.equal(s_k, s_p)


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
        got = ops.block_scatter(di, dv, dc, dim, index)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))
    assert scatter_mod.launches == before + 2
