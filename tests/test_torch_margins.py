"""A step's margins and exact-lazy catch-up over all q blocks at once.

``ops.step_margins`` gathers a step's sampled rows in every block, takes
each block's partial margins and sums them in tree order (Alg 1 lines
9-10); ``ops.snapshot_margins`` does the same for every row (lines 3-4);
``ops.lazy_step_catchup`` replays the deferred decay of every feature the
step's rows touch, in every block.  On the card each is one kernel launch
for the q blocks; on the CPU each is its plain version, which these tests
hold, over q in {1, 3, 8} and u in {1, 4}, on rows with a hot id repeated
in every row, genuine id-0 entries, trailing padding (id 0, value 0.0)
and repeated sampled rows:

* bitwise against the per-block plain versions the path ran before
  (``local_margins`` plus ``tree_order_sum``, the torch gathers, and
  ``lazy_catchup_plain`` block after block);
* against the reference: ``repro.kernels.ref.sparse_margin_ref`` per block
  plus ``repro.dist.tree.tree_order_sum``, ``|d| <= 1e-6 * sum_l sum_k
  |w_l[idx] * val|`` per row (XLA and PyTorch sum a row in other orders);
  ``repro.kernels.ref.lazy_catchup_ref`` on the blocks' global ids,
  ``|d| <= 1e-6 * (k + 1) * (|w| + |want| + eta * |z|)`` per feature (k the
  steps it replays; XLA may contract ``w - eta * g`` into an FMA) and
  ``last`` exact.

The kernels compile only on the card: the tests marked ``cuda`` hold them
there, at u in {1, 8, 64} (64 rows fill several of the catch-up's
256-position ownership ranges), bitwise against q one-block launches plus
``tree_order_sum`` and against the CPU's plain versions, and skip here.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.tree import tree_order_sum as r_tree_order_sum
from repro.kernels import ref as r_ref

from repro_torch.core.partition import FeaturePartition
from repro_torch.data.block_csr import BlockCSR, local_margins
from repro_torch.dist.tree import tree_order_sum
from repro_torch.kernels import _build, ops
from repro_torch.kernels import lazy_update as lazy_mod
from repro_torch.kernels import sparse_margin as margin_mod

QS = [1, 3, 8]
US = [1, 4]
RTOL = 1e-6
N_ROWS = 90
# (lam, lam1, lam2) of each regularizer setting, as the kernels take them.
LAMS = {
    "l2": (1e-3, 0.0, 0.0),
    "l1": (0.0, 1e-3, 0.0),
    "elastic_net": (0.0, 1e-3, 1e-2),
    "none": (0.0, 0.0, 0.0),
}
ETA = 0.1
M = 40  # the step index; `last` holds earlier steps
CATCHUP_STOPS = {"unmasked": M, "masked tail": 29}


def _layout(q: int, seed: int = 0) -> BlockCSR:
    """q blocks of N_ROWS rows: block l has 40 + 31l features and rows of
    width 6 + 3 * (l % 4), with a hot id repeated in every row of the
    blocks l % 3 == 0 (4 copies), a genuine id 0 in some rows, and 1-2
    trailing padding entries (id 0, value 0.0)."""
    rng = np.random.default_rng(seed)
    dims = [40 + 31 * l for l in range(q)]
    indices, values = [], []
    for l, dim in enumerate(dims):
        width = 6 + 3 * (l % 4)
        idx = rng.integers(1, dim, size=(N_ROWS, width)).astype(np.int32)
        val = rng.normal(size=(N_ROWS, width)).astype(np.float32)
        if l % 3 == 0:
            idx[:, 1:5] = dim // 2
        idx[::7, 0] = 0  # a genuine id 0
        pad = 1 + l % 2
        idx[:, width - pad:], val[:, width - pad:] = 0, 0.0
        indices.append(torch.from_numpy(idx))
        values.append(torch.from_numpy(val))
    bounds = tuple(int(b) for b in np.concatenate([[0], np.cumsum(dims)]))
    labels = torch.from_numpy(np.where(rng.random(N_ROWS) < 0.5, -1.0, 1.0).astype(np.float32))
    return BlockCSR(partition=FeaturePartition(dim=bounds[-1], bounds=bounds),
                    indices=tuple(indices), values=tuple(values), labels=labels, dim=bounds[-1])


def _ids(u: int, seed: int = 1) -> torch.Tensor:
    ids = np.random.default_rng(seed).integers(0, N_ROWS, size=u).astype(np.int64)
    if u > 1:
        ids[1] = ids[0]  # a row sampled twice
    return torch.from_numpy(ids)


def _w(bd: BlockCSR, seed: int = 2) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(size=bd.dim).astype(np.float32))


def _blocks(bd, w):
    b = bd.partition.bounds
    return [w[b[l]:b[l + 1]] for l in range(bd.num_blocks)]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.int32)


# ---------------------------------------------------------------------------
# the margins' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u", US)
@pytest.mark.parametrize("q", QS)
def test_step_margins_equal_per_block_local_margins_and_tree_sum_bitwise(q, u):
    bd, ids = _layout(q), _ids(u)
    w = _w(bd)
    rows = [(bd.indices[l][ids], bd.values[l][ids]) for l in range(q)]
    parts = [local_margins(i, v, w_l) for (i, v), w_l in zip(rows, _blocks(bd, w))]
    ops.reset_launch_counts()
    got = ops.step_margins(bd, ids, w, partials=True)
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert got.s.shape == (u,) and np.array_equal(_bits(got.s), _bits(tree_order_sum(parts)))
    assert got.parts.shape == (q, u)
    assert np.array_equal(_bits(got.parts), _bits(torch.stack(parts)))
    for (gi, gv), (wi, wv) in zip(got.rows, rows, strict=True):
        assert torch.equal(gi, wi) and torch.equal(gv, wv)
    # Into a reused buffer: the same rows, views of two flat buffers.
    buf = ops.step_rows(bd, u)
    again = ops.step_margins(bd, ids, w, out=buf)
    assert again.parts is None and torch.equal(again.s, got.s)
    offset = 0
    for (bi, bv), (wi, wv) in zip(again.rows, rows, strict=True):
        assert bi.data_ptr() == buf.indices.data_ptr() + 4 * offset
        assert bv.data_ptr() == buf.values.data_ptr() + 4 * offset
        assert torch.equal(bi, wi) and torch.equal(bv, wv) and bi.is_contiguous()
        offset += wi.numel()
    assert offset == buf.indices.numel() == u * sum(bd.nnz_budgets)


@pytest.mark.parametrize("q", QS)
def test_snapshot_margins_equal_per_block_local_margins_and_tree_sum_bitwise(q):
    bd = _layout(q)
    w = _w(bd)
    want = tree_order_sum([local_margins(i, v, w_l)
                           for i, v, w_l in zip(bd.indices, bd.values, _blocks(bd, w))])
    ops.reset_launch_counts()
    got = ops.snapshot_margins(bd, w)
    assert set(ops.launch_counts().values()) == {0}
    assert got.shape == (N_ROWS,) and np.array_equal(_bits(got), _bits(want))


def _reference_margins(bd, w, ids):
    """sparse_margin_ref per block, summed by the reference's tree_order_sum;
    and the per-row scale sum_l sum_k |w_l[idx] * val|."""
    rows = [(i.numpy(), v.numpy()) for i, v in zip(bd.indices, bd.values)]
    if ids is not None:
        rows = [(i[ids.numpy()], v[ids.numpy()]) for i, v in rows]
    blocks = [w_l.numpy() for w_l in _blocks(bd, w)]
    parts = [r_ref.sparse_margin_ref(jnp.asarray(w_l), jnp.asarray(i), jnp.asarray(v))
             for (i, v), w_l in zip(rows, blocks)]
    scale = sum(np.sum(np.abs(w_l[i] * v), axis=-1) for (i, v), w_l in zip(rows, blocks))
    return np.asarray(r_tree_order_sum(parts)), scale


@pytest.mark.parametrize("u", US + [None])
@pytest.mark.parametrize("q", QS)
def test_margins_match_the_reference(q, u):
    """u = None: the snapshot's margins of every row."""
    bd = _layout(q, seed=q)
    w = _w(bd, seed=q + 10)
    ids = None if u is None else _ids(u, seed=q + 20)
    got = ops.snapshot_margins(bd, w) if ids is None else ops.step_margins(bd, ids, w).s
    want, scale = _reference_margins(bd, w, ids)
    assert np.all(np.abs(got.numpy() - want) <= RTOL * scale)


# ---------------------------------------------------------------------------
# the step catch-up's plain version
# ---------------------------------------------------------------------------


def _catchup_state(bd, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=bd.dim).astype(np.float32)
    w[:3] = 0.0
    last = rng.integers(0, M, size=bd.dim).astype(np.int32)
    z = (rng.normal(size=bd.dim) * 0.5).astype(np.float32)
    return w, last, z


@pytest.mark.parametrize("case", list(CATCHUP_STOPS))
@pytest.mark.parametrize("reg", list(LAMS))
@pytest.mark.parametrize("u", US)
@pytest.mark.parametrize("q", QS)
def test_step_catchup_equals_per_block_plain_bitwise_and_the_reference(q, u, reg, case):
    lam, lam1, lam2 = LAMS[reg]
    stop = CATCHUP_STOPS[case]
    bd, ids = _layout(q, seed=q), _ids(u, seed=u)
    w, last, z = _catchup_state(bd, seed=q + u)
    tw, tlast, tz = (torch.from_numpy(a.copy()) for a in (w, last, z))
    ops.reset_launch_counts()
    got_w, got_last = ops.lazy_step_catchup(bd, ids, tw, tlast, tz, ETA, M, stop,
                                            lam=lam, lam1=lam1, lam2=lam2)
    assert set(ops.launch_counts().values()) == {0}
    assert got_w is tw and got_last is tlast  # in place
    # Bitwise: lazy_catchup_plain block after block, on each block's gathered rows.
    pw, plast, pz = (torch.from_numpy(a.copy()) for a in (w, last, z))
    for l, ((wl, ll, zl), idx) in enumerate(zip(zip(_blocks(bd, pw), _blocks(bd, plast),
                                                    _blocks(bd, pz)), bd.indices)):
        lazy_mod.lazy_catchup_plain(wl, ll, zl, idx[ids], ETA, M, stop, lam, lam1, lam2)
    assert np.array_equal(_bits(got_w), _bits(pw)) and torch.equal(got_last, plast)
    # The reference on the blocks' global ids: the q blocks hold disjoint features.
    b = bd.partition.bounds
    flat = np.concatenate([bd.indices[l][ids].numpy() + b[l] for l in range(q)], axis=1)
    ref_w, ref_last = r_ref.lazy_catchup_ref(
        jnp.asarray(w), jnp.asarray(last), jnp.asarray(z), jnp.asarray(flat), jnp.float32(ETA),
        jnp.int32(M), jnp.int32(stop), lam=jnp.float32(lam), lam1=lam1, lam2=lam2)
    np.testing.assert_array_equal(got_last.numpy(), np.asarray(ref_last))
    k = np.maximum(min(stop, M) - last, 0) + 1
    tol = RTOL * k * (np.abs(w) + np.abs(np.asarray(ref_w)) + ETA * np.abs(z))
    assert np.all(np.abs(got_w.numpy() - np.asarray(ref_w)) <= tol)
    untouched = np.setdiff1d(np.arange(bd.dim), np.unique(flat))
    assert np.array_equal(got_w.numpy()[untouched], w[untouched])


# ---------------------------------------------------------------------------
# misuse, as far as the CPU can check it
# ---------------------------------------------------------------------------


def test_new_entries_refuse_unknown_devices_and_cpu_tensors_at_the_kernels():
    bd = _layout(3)
    w, ids = _w(bd), _ids(2)
    last, z = torch.zeros(bd.dim, dtype=torch.int32), torch.zeros(bd.dim)
    meta = w.to("meta")
    for call in (lambda: ops.step_margins(bd, ids, meta),
                 lambda: ops.snapshot_margins(bd, meta),
                 lambda: ops.lazy_step_catchup(bd, ids, meta, last, z, ETA, M, M, lam=0.0)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
    rows = _build.BlockRows()
    with pytest.raises(ValueError, match="CUDA tensors"):
        margin_mod.margins(rows, 3, w, ids, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lazy_mod.catchup(rows, 3, ids, 2, w, last, z, ETA, M, M, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        margin_mod.sparse_margin(bd.indices[0], bd.values[0], w[:40])
    with pytest.raises(ValueError, match="CUDA tensors"):
        bd.block_rows()  # the kernels' rows live on a card
    with pytest.raises(ValueError, match="one launch takes"):
        _build.block_rows("sparse_margin", bd.indices * 43, None, [1] * 129,
                          torch.device("cuda"))


def test_block_rows_layout_matches_the_kernels_struct():
    assert ctypes.sizeof(_build.BlockRows) == 3584  # touched.cuh's static_assert
    text = (_build.CSRC / "touched.cuh").read_text()
    assert "struct BlockRows" in text and 'sizeof(BlockRows) == 3584' in text
    assert _build.MAX_BLOCKS == 128 and "kMaxBlocks = 128" in text


def test_copies_of_a_layout_keep_their_own_block_rows():
    """The BlockRows hold raw pointers, so .to() and dataclasses.replace
    never pass the cache on (the snapshot index, pointer-free, is shared)."""
    bd = _layout(3)
    copy = bd.to("cpu")
    assert copy._block_rows is not bd._block_rows
    assert copy._snapshot_index is bd._snapshot_index


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


CARD_US = [1, 8, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("u", CARD_US + [None])
@pytest.mark.parametrize("q", QS)
def test_margins_kernel_equals_one_block_launches_and_tree_sum_on_card(cuda_device, q, u):
    """One launch; s and the partials bitwise q one-block launches plus
    tree_order_sum, the rows equal to the torch gathers, twice; s within
    the margin tolerance of the plain version.  u = None: the snapshot."""
    bd = _layout(q, seed=q).to(cuda_device)
    w = _w(bd, seed=q + 10).to(cuda_device)
    ids = None if u is None else _ids(u, seed=q + 20).to(cuda_device)
    rows = list(zip(bd.indices, bd.values)) if ids is None else \
        [(i[ids], v[ids]) for i, v in zip(bd.indices, bd.values)]
    singles = [margin_mod.sparse_margin(i, v, w_l) for (i, v), w_l in zip(rows, _blocks(bd, w))]
    for _ in range(2):
        ops.reset_launch_counts()
        if ids is None:
            s, parts = ops.snapshot_margins(bd, w), None
        else:
            s, got_rows, parts = ops.step_margins(bd, ids, w, partials=True)
        assert ops.launch_counts()["sparse_margin"] == 1
        torch.cuda.synchronize()
        assert torch.equal(s, tree_order_sum(singles))
        if parts is not None:
            assert torch.equal(parts, torch.stack(singles))
            for (gi, gv), (wi, wv) in zip(got_rows, rows, strict=True):
                assert torch.equal(gi, wi) and torch.equal(gv, wv)
    plain = margin_mod.margins_plain(bd.indices, bd.values, _blocks(bd, w), ids)[0]
    scale = sum(torch.sum(torch.abs(w_l[i] * v), -1) for (i, v), w_l in zip(rows, _blocks(bd, w)))
    assert bool(torch.all(torch.abs(s - plain) <= RTOL * scale))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CATCHUP_STOPS))
@pytest.mark.parametrize("reg", list(LAMS))
@pytest.mark.parametrize("u", CARD_US)
@pytest.mark.parametrize("q", QS)
def test_step_catchup_kernel_equals_cpu_plain_bitwise_on_card(cuda_device, q, u, reg, case):
    lam, lam1, lam2 = LAMS[reg]
    stop = CATCHUP_STOPS[case]
    bd_cpu = _layout(q, seed=q)
    bd, ids_cpu = bd_cpu.to(cuda_device), _ids(u, seed=u)
    state = _catchup_state(bd_cpu, seed=q + u)
    want_w, want_last, z_cpu = (torch.from_numpy(a.copy()) for a in state)
    ops.lazy_step_catchup(bd_cpu, ids_cpu, want_w, want_last, z_cpu, ETA, M, stop,
                          lam=lam, lam1=lam1, lam2=lam2)
    for _ in range(2):
        w, last, z = (torch.from_numpy(a.copy()).to(cuda_device) for a in state)
        ops.reset_launch_counts()
        ops.lazy_step_catchup(bd, ids_cpu.to(cuda_device), w, last, z, ETA, M, stop,
                              lam=lam, lam1=lam1, lam2=lam2)
        assert ops.launch_counts()["lazy_catchup"] == 1
        torch.cuda.synchronize()
        assert np.array_equal(_bits(w), _bits(want_w)) and torch.equal(last.cpu(), want_last)
    # Block 0 alone through the one-block wrapper (the q = 1 case of the launch).
    w0, last0, z0 = (torch.from_numpy(a.copy()).to(cuda_device) for a in state)
    d0 = bd.block_dims[0]
    lazy_mod.lazy_catchup(w0[:d0], last0[:d0], z0[:d0], bd.indices[0][ids_cpu.to(cuda_device)],
                          ETA, M, stop, lam, lam1, lam2)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(w0[:d0]), _bits(want_w[:d0]))
    assert torch.equal(last0[:d0].cpu(), want_last[:d0])
