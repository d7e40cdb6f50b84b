"""A step's and a snapshot's loss coefficients, and the epoch-end flush
over the whole width.

``ops.step_coef`` gives a step's ``(dl(s_m, y) - dl(s0[ids], y)) / u``
with ``y = labels[ids]``, ``ops.snapshot_coef`` a snapshot's ``dl(s0,
labels) / N``; on the card each is one launch of the coefficient kernel
(``csrc/logistic_grad.cu``) for the logistic loss, on the CPU its plain
version, and for the other three losses the chain of PyTorch ops
everywhere.  ``ops.lazy_block_flush`` over the q blocks' ``w``, ``last``
and ``z`` whole replays every feature's deferred steps at once (the
epoch's flush).  On the CPU these tests hold:

* the plain versions bitwise against the chains the path ran before
  (``core.losses.logistic.dvalue``, a subtraction and a true division by a
  0-dim tensor), at u = 1, 8, 64 and a 2,000-row snapshot, on margins
  that include +-100;
* against the reference (``repro.core.losses.logistic.dvalue`` in jax):
  ``|d| <= 4 * 2**-23 * (|dl(s_m, y)| + |dl(s0[ids], y)|) / u`` per row
  for a step and ``4 * 2**-23 * |dl(s0, y)| / N`` for a snapshot
  (``jax.nn.sigmoid`` and ``torch.sigmoid`` each round to within 2 ulp;
  the subtraction and the division round once more);
* the other losses' route to the chain, the snapshot's coefficients of
  the kernel and the plain path bitwise for every loss, and the refusals;
* the whole-width flush bitwise the 8 one-block ``lazy_flush_plain``
  calls, for the four regularizers, with and without a masked tail.

The kernels compile only on the card: the tests marked ``cuda`` hold them
there bitwise against the card's plain versions and, moved to the CPU,
against the reference with the tolerance above; they skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as r_losses

from repro_torch.core import losses as t_losses
from repro_torch.core.fdsvrg import _full_grad_blocks
from repro_torch.core.partition import FeaturePartition, balanced
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.synthetic import make_sparse_classification
from repro_torch.kernels import lazy_update as lazy_mod
from repro_torch.kernels import logistic_grad as logistic_mod
from repro_torch.kernels import ops

N = 2000
US = [1, 8, 64]
EPS32 = 2.0**-23
REF_ULPS = 4
Q = 8
# (lam, lam1, lam2) of each regularizer setting, as the kernels take them.
LAMS = {
    "l2": (1e-3, 0.0, 0.0),
    "l1": (0.0, 1e-3, 0.0),
    "elastic_net": (0.0, 1e-3, 1e-2),
    "none": (0.0, 0.0, 0.0),
}
TOTAL = 40
STOPS = {"unmasked": TOTAL, "masked tail": 29}


def _layout(seed: int = 0) -> BlockCSR:
    """N rows of labels in {-1, +1}; the coefficients read nothing else of
    the layout (one block of one feature, all rows id 0)."""
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32))
    return BlockCSR(partition=FeaturePartition(dim=1, bounds=(0, 1)),
                    indices=(torch.zeros((N, 1), dtype=torch.int32),),
                    values=(torch.ones((N, 1)),), labels=labels, dim=1)


def _margins(size: int, seed: int) -> torch.Tensor:
    """Margins of the path's scale, with a few extremes (+-100, +-30)."""
    s = np.random.default_rng(seed).normal(0.0, 3.0, size=size).astype(np.float32)
    s[:4] = np.array([100.0, -100.0, 30.0, -30.0], dtype=np.float32)[:size]
    return torch.from_numpy(s)


def _step_case(u: int):
    rng = np.random.default_rng(u)
    ids = rng.integers(0, N, size=u).astype(np.int64)
    ids[:min(u, 4)] = np.arange(min(u, 4))  # the rows with extreme s0
    if u > 4:
        ids[5] = ids[4]  # a row sampled twice
    return torch.from_numpy(ids), _margins(u, seed=100 + u)


def _u_t(u: int) -> torch.Tensor:
    return torch.full((), float(u), dtype=torch.float32)


def _snapshot_chain(dvalue, s0: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The snapshot's chain before: the derivative, then a true division
    by a 0-dim tensor holding N."""
    return dvalue(s0, labels) / torch.full((), float(N), device=s0.device)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.int32)


# ---------------------------------------------------------------------------
# the plain versions, the reference, the routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u", US)
def test_step_coef_plain_is_the_chain_before_bitwise(u):
    bd, s0 = _layout(), _margins(N, seed=1)
    ids, s_m = _step_case(u)
    y = bd.labels[ids]
    d = t_losses.logistic.dvalue
    want = (d(s_m, y) - d(s0[ids], y)) / _u_t(u)
    ops.reset_launch_counts()
    got = ops.step_coef(bd, ids, s_m, s0, _u_t(u), t_losses.logistic)
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert got.shape == (u,) and bool(torch.all(torch.isfinite(got)))
    assert np.array_equal(_bits(got), _bits(want))
    plain = logistic_mod.step_coef_plain(s_m, ids, bd.labels, s0, _u_t(u), d)
    assert np.array_equal(_bits(plain), _bits(want))


def test_snapshot_coef_plain_is_the_chain_before_bitwise():
    bd, s0 = _layout(), _margins(N, seed=1)
    want = _snapshot_chain(t_losses.logistic.dvalue, s0, bd.labels)
    ops.reset_launch_counts()
    got = ops.snapshot_coef(bd, s0, t_losses.logistic)
    assert set(ops.launch_counts().values()) == {0}
    assert got.shape == (N,) and bool(torch.all(torch.isfinite(got)))
    assert np.array_equal(_bits(got), _bits(want))
    plain = logistic_mod.snapshot_coef_plain(s0, bd.labels, N, t_losses.logistic.dvalue)
    assert np.array_equal(_bits(plain), _bits(want))


def _step_ratio(u: int, device: str | torch.device = "cpu") -> float:
    """max |port - reference| / tolerance over a step's u rows, the port's
    coefficients computed on ``device`` (the kernel on a CUDA device)."""
    bd, s0 = _layout(), _margins(N, seed=1)
    ids, s_m = _step_case(u)
    got = ops.step_coef(bd.to(device), ids.to(device), s_m.to(device), s0.to(device),
                        _u_t(u).to(device), t_losses.logistic).cpu().numpy()
    y = jnp.asarray(bd.labels.numpy()[ids.numpy()])
    d1 = r_losses.logistic.dvalue(jnp.asarray(s_m.numpy()), y)
    d0 = r_losses.logistic.dvalue(jnp.asarray(s0.numpy()[ids.numpy()]), y)
    want = np.asarray((d1 - d0) / u)
    tol = REF_ULPS * EPS32 * (np.abs(np.asarray(d1)) + np.abs(np.asarray(d0))) / u
    return float(np.max(np.abs(got - want) / np.maximum(tol, 1e-37)))


def _snapshot_ratio(device: str | torch.device = "cpu") -> float:
    bd, s0 = _layout(), _margins(N, seed=1)
    got = ops.snapshot_coef(bd.to(device), s0.to(device), t_losses.logistic).cpu().numpy()
    d = np.asarray(r_losses.logistic.dvalue(jnp.asarray(s0.numpy()),
                                             jnp.asarray(bd.labels.numpy())))
    want = np.asarray(jnp.asarray(d) / N)
    tol = REF_ULPS * EPS32 * np.abs(d) / N
    return float(np.max(np.abs(got - want) / np.maximum(tol, 1e-37)))


@pytest.mark.parametrize("u", US + [None])
def test_coefficients_match_the_reference(u):
    """u = None: the snapshot's N rows."""
    assert (_snapshot_ratio() if u is None else _step_ratio(u)) <= 1.0


@pytest.mark.parametrize("name", ["squared_hinge", "hinge", "squared"])
def test_other_losses_take_the_chain(name):
    """No TPU kernel exists for these losses: the chain of PyTorch ops
    with the loss's own derivative, on every device."""
    loss = t_losses.LOSSES[name]
    bd, s0 = _layout(), _margins(N, seed=2)
    ids, s_m = _step_case(8)
    y = bd.labels[ids]
    ops.reset_launch_counts()
    got = ops.step_coef(bd, ids, s_m, s0, _u_t(8), loss)
    snap = ops.snapshot_coef(bd, s0, loss)
    assert set(ops.launch_counts().values()) == {0}
    want = (loss.dvalue(s_m, y) - loss.dvalue(s0[ids], y)) / _u_t(8)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(snap), _bits(_snapshot_chain(loss.dvalue, s0, bd.labels)))
    # Not the logistic chain: the route follows loss.name.
    assert not torch.equal(got, ops.step_coef(bd, ids, s_m, s0, _u_t(8), t_losses.logistic))


@pytest.mark.parametrize("name", ["logistic", "squared_hinge", "hinge", "squared"])
def test_snapshot_of_the_kernel_and_plain_paths_bitwise(name):
    """A snapshot's coefficients through ops.snapshot_coef (the kernel
    path) and snapshot_coef_plain (the plain path) feed the same scatter."""
    data = make_sparse_classification(dim=600, num_instances=90, nnz_per_instance=12, seed=4)
    bd = BlockCSR.from_padded(data, balanced(600, 3))
    w = torch.from_numpy(np.random.default_rng(5).normal(0.0, 0.5, size=600).astype(np.float32))
    loss = t_losses.LOSSES[name]
    z_k, s_k = _full_grad_blocks(bd, w, loss, True)
    z_p, s_p = _full_grad_blocks(bd, w, loss, False)
    assert torch.equal(s_k, s_p)
    assert np.array_equal(_bits(z_k), _bits(z_p))
    assert bool(torch.any(z_k != 0.0))


def test_coefficient_entries_refuse_cpu_tensors_and_unknown_devices():
    bd, s0 = _layout(), _margins(N, seed=1)
    ids, s_m = _step_case(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        logistic_mod.step_coef(s_m, ids, bd.labels, s0, _u_t(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        logistic_mod.snapshot_coef(s0, bd.labels, N)
    meta = s_m.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.step_coef(bd, ids, meta, s0, _u_t(8), t_losses.logistic)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.snapshot_coef(bd, s0.to("meta"), t_losses.logistic)


# ---------------------------------------------------------------------------
# the whole-width flush
# ---------------------------------------------------------------------------


def _flush_state(seed: int = 3):
    """Q blocks of 37 + 11l features, a w with exact zeros, last in [0, TOTAL]."""
    dims = [37 + 11 * l for l in range(Q)]
    bounds = np.concatenate([[0], np.cumsum(dims)])
    rng = np.random.default_rng(seed)
    d = int(bounds[-1])
    w = rng.normal(0.0, 0.1, size=d).astype(np.float32)
    w[::9] = 0.0
    last = rng.integers(0, TOTAL + 1, size=d).astype(np.int32)
    z = rng.normal(0.0, 1e-2, size=d).astype(np.float32)
    return [int(b) for b in bounds], w, last, z


@pytest.mark.parametrize("case", list(STOPS))
@pytest.mark.parametrize("reg", list(LAMS))
def test_epoch_flush_equals_one_block_flushes_bitwise(reg, case):
    lam, lam1, lam2 = LAMS[reg]
    stop = STOPS[case]
    bounds, w, last, z = _flush_state()
    tw, tlast, tz = (torch.from_numpy(a.copy()) for a in (w, last, z))
    ops.reset_launch_counts()
    got = ops.lazy_block_flush(tw, tlast, tz, 0.1, TOTAL, stop, lam=lam, lam1=lam1, lam2=lam2)
    assert got is tw and set(ops.launch_counts().values()) == {0}
    pw, plast, pz = (torch.from_numpy(a.copy()) for a in (w, last, z))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lazy_mod.lazy_flush_plain(pw[lo:hi], plast[lo:hi], pz[lo:hi], 0.1, TOTAL, stop,
                                  lam, lam1, lam2)
    assert np.array_equal(_bits(got), _bits(pw))
    assert torch.equal(tlast, torch.from_numpy(last))  # the flush reads last only
    assert not np.array_equal(_bits(got), w.view(np.int32))


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("u", US + [None])
def test_coefficient_kernels_equal_plain_bitwise_on_card(cuda_device, u):
    """One launch each, bitwise the card's plain version (PyTorch's CUDA
    sigmoid and true division), finite at margins of +-100, twice.
    u = None: the snapshot."""
    bd = _layout().to(cuda_device)
    s0 = _margins(N, seed=1).to(cuda_device)
    loss = t_losses.logistic
    for _ in range(2):
        ops.reset_launch_counts()
        if u is None:
            got = ops.snapshot_coef(bd, s0, loss)
            want = _snapshot_chain(loss.dvalue, s0, bd.labels)
        else:
            ids, s_m = (t.to(cuda_device) for t in _step_case(u))
            u_t = _u_t(u).to(cuda_device)
            got = ops.step_coef(bd, ids, s_m, s0, u_t, loss)
            y = bd.labels[ids]
            want = (loss.dvalue(s_m, y) - loss.dvalue(s0[ids], y)) / u_t
        assert ops.launch_counts()["logistic_grad"] == 1
        torch.cuda.synchronize()
        assert bool(torch.all(torch.isfinite(got)))
        assert np.array_equal(_bits(got), _bits(want))
    # The kernel's output against the reference (jax, on the CPU).
    assert (_snapshot_ratio(cuda_device) if u is None else _step_ratio(u, cuda_device)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["squared_hinge", "hinge", "squared"])
def test_other_losses_take_the_chain_on_card(cuda_device, name):
    loss = t_losses.LOSSES[name]
    bd = _layout().to(cuda_device)
    s0 = _margins(N, seed=2).to(cuda_device)
    ids, s_m = (t.to(cuda_device) for t in _step_case(8))
    u_t = _u_t(8).to(cuda_device)
    ops.reset_launch_counts()
    got = ops.step_coef(bd, ids, s_m, s0, u_t, loss)
    snap = ops.snapshot_coef(bd, s0, loss)
    assert set(ops.launch_counts().values()) == {0}
    y = bd.labels[ids]
    assert torch.equal(got, (loss.dvalue(s_m, y) - loss.dvalue(s0[ids], y)) / u_t)
    assert torch.equal(snap, _snapshot_chain(loss.dvalue, s0, bd.labels))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STOPS))
@pytest.mark.parametrize("reg", list(LAMS))
def test_epoch_flush_kernel_equals_one_block_launches_bitwise_on_card(cuda_device, reg, case):
    """One launch over the whole width, bitwise the Q one-block launches
    and the CPU's plain flush."""
    lam, lam1, lam2 = LAMS[reg]
    stop = STOPS[case]
    bounds, w, last, z = _flush_state()
    tw, tlast, tz = (torch.from_numpy(a.copy()).to(cuda_device) for a in (w, last, z))
    ops.reset_launch_counts()
    lazy_mod.lazy_flush(tw, tlast, tz, 0.1, TOTAL, stop, lam, lam1, lam2)
    assert ops.launch_counts()["lazy_flush"] == 1
    bw, blast, bz = (torch.from_numpy(a.copy()).to(cuda_device) for a in (w, last, z))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lazy_mod.lazy_flush(bw[lo:hi], blast[lo:hi], bz[lo:hi], 0.1, TOTAL, stop,
                            lam, lam1, lam2)
    cw = torch.from_numpy(w.copy())
    lazy_mod.lazy_flush_plain(cw, torch.from_numpy(last), torch.from_numpy(z), 0.1, TOTAL, stop,
                              lam, lam1, lam2)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(tw), _bits(bw)) and np.array_equal(_bits(tw), _bits(cw))
    ops.reset_launch_counts()
    ew = torch.from_numpy(w.copy()).to(cuda_device)
    ops.lazy_block_flush(ew, tlast, tz, 0.1, TOTAL, stop, lam=lam, lam1=lam1, lam2=lam2)
    assert ops.launch_counts()["lazy_flush"] == 1
    assert np.array_equal(_bits(ew), _bits(cw))


if __name__ == "__main__":
    # Worst error against the reference, as a fraction of the stated
    # tolerance:  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_coef.py
    print({"step u=%d" % u: _step_ratio(u) for u in US} | {"snapshot": _snapshot_ratio()})
