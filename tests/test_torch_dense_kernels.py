"""The port's dense-layout step, held against the reference's Pallas kernels.

The dense layout keeps one feature block as a dense ``[d, N]`` matrix:
``margins_dense`` (``S = wᵀD``), ``loss_and_grad`` (the fused logistic
loss and derivative), ``svrg_dense_update`` (the dense L2 update) and, in
the BlockCSR layout, ``fused_block_update``.  On the CPU each
``repro_torch.kernels.ops`` wrapper takes its kernel's plain PyTorch
version; these tests hold it against the reference's wrapper with its
Pallas kernel in interpret mode (as the reference's own tests run it), at
the reference's own shapes, on inputs made from a seed with numpy.
Stated tolerances, port against reference:

* ``margins_dense``: ``|d| <= 1e-6 * sum_k |w[k] * D[k, n]|`` per column,
  float32 and bfloat16 inputs (both sum float32 products, in other orders);
* ``loss_and_grad``: ``|d| <= 4 * ulp(max(|want|, 1))`` for both outputs
  (PyTorch's exp and log against XLA's, a few ulp apart; ``log(1 + tiny)``
  turns one ulp of the sum into an absolute error);
* ``svrg_dense_update``: ``|d| <= 1e-6 * (|c*w| + |eta*(g + z)|)``, one
  rounding of the terms (XLA may contract the update into an FMA);
* ``fused_block_update``: ``|d| <= 1e-6 * (|w| + |want| + eta * |g + z|)``,
  one rounding of the update's terms (XLA may contract it into an FMA);
* the composed SVRG step (``tests/test_kernels.py:159``): the next ``w``
  within ``1e-6 * max|w|`` of the reference's composed step.

``make_dense_classification`` must equal the reference's byte for byte.
The ``cuda``-marked tests hold each CUDA kernel against its plain version
on a card (tails, ``N = 1``, bfloat16) and skip here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data.synthetic import make_dense_classification as r_make_dense
from repro.kernels import ops as r_ops

from repro_torch import convert
from repro_torch.core import losses as t_losses
from repro_torch.data.synthetic import make_dense_classification as t_make_dense
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fd_matvec as matvec_mod
from repro_torch.kernels import fused_update as fused_mod
from repro_torch.kernels import logistic_grad as logistic_mod
from repro_torch.kernels import prox_update as prox_mod
from repro_torch.kernels import svrg_update as svrg_mod

MATVEC_RTOL = 1e-6
LOSS_ULPS = 4
SVRG_RTOL = 1e-6
FUSED_RTOL = 1e-6
STEP_RTOL = 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# news20 per-block nnz budgets at q = 8, and the q = 1 width.
NEWS20_WIDTHS = [161, 75, 75, 93, 69, 109, 47, 72, 455]


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing above ``|x|``."""
    a = torch.abs(x.float())
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _unchanged_counts(fn):
    before = ops.launch_counts()
    out = fn()
    assert ops.launch_counts() == before  # the CPU takes the plain version
    return out


# ---------------------------------------------------------------------------
# margins_dense (fd_matvec)
# ---------------------------------------------------------------------------


def _matvec_error_ratio(d, n, dtype) -> float:
    """max_n |port - reference| / (1e-6 * sum_k |w[k] * D[k, n]|)."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(d * 1000 + n)
    w = rng.normal(size=d).astype(np.float32)
    D = rng.normal(size=(d, n)).astype(np.float32)
    want = np.asarray(r_ops.margins_dense(jnp.asarray(w, jd), jnp.asarray(D, jd), interpret=True))
    wt, Dt = torch.from_numpy(w).to(td), torch.from_numpy(D).to(td)
    got = _unchanged_counts(lambda: ops.margins_dense(wt, Dt))
    assert got.dtype == torch.float32 and got.shape == (n,)
    scale = torch.sum(torch.abs(wt.float()[:, None] * Dt.float()), dim=0).numpy()
    return float(np.max(np.abs(got.numpy() - want) / (MATVEC_RTOL * scale + 1e-30)))


@pytest.mark.parametrize("d,n", [(512, 256), (1024, 512), (777, 130), (512, 1), (1, 7)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_margins_dense_matches_reference_kernel(d, n, dtype):
    assert _matvec_error_ratio(d, n, dtype) <= 1.0


@pytest.mark.parametrize("d,n", [(1, 1), (169_399, 1), (169_399, 19_954), (777, 130),
                                 (29_890_095, 1), (5000, 300), (169_399, 2), (169_399, 7),
                                 (5000, 7)])
def test_fd_matvec_slices_fit_the_kernel(d, n):
    """The geometry the wrapper picks on an H100 (132 SMs) is one the kernel
    takes, for float32 and bfloat16, a contiguous D and a column view of a
    wider one (row stride ld > N): a thread's load is a power of two of
    elements that divides N, ld and the address, at most 16 bytes (16
    where they are aligned); a power of two of threads along the columns,
    just enough to cover N; the staged rows and the tree's scratch within
    48 KB, at most 65535 slices, every row in exactly one slice; about
    64 blocks an SM unless a thread would get fewer than 8 rows or the
    slices are full; at N = 1 one column a thread and the rows give the
    blocks."""
    sms = 132
    for elt in (4, 2):
        for ld, addr in ((n, 256), (3 * n + 1, 256), (n, 256 + elt)):
            vec, tx, rows = matvec_mod.geometry(d, n, ld, addr, elt, sms)
            assert vec * elt <= matvec_mod.MAX_LOAD_BYTES and 16 % (vec * elt) == 0
            assert n % vec == 0 and ld % vec == 0 and addr % (vec * elt) == 0
            if n % (16 // elt) == 0 and ld % (16 // elt) == 0 and addr % 16 == 0:
                assert vec == 16 // elt  # 16-byte loads where they are aligned
            assert tx & (tx - 1) == 0 and 1 <= tx <= matvec_mod.THREADS
            assert tx * vec >= n or tx == matvec_mod.THREADS
            assert tx == 1 or (tx // 2) * vec < n
            col_blocks = -(-n // (tx * vec))
            slices = -(-d // rows)
            ty = matvec_mod.THREADS // tx
            scratch = 4 * matvec_mod.THREADS * vec if ty > 1 else 0
            assert rows >= 1
            assert 4 * rows + scratch <= matvec_mod.SHARED_BYTES
            assert slices <= 65535 and (slices - 1) * rows < d <= slices * rows
            target = matvec_mod.BLOCKS_PER_SM * sms
            full = (matvec_mod.SHARED_BYTES - scratch) // 4
            assert (col_blocks * slices <= max(col_blocks, target)
                    or rows in (matvec_mod.MIN_ROWS_PER_THREAD * ty, full))
            if n == 1:
                assert (vec, tx) == (1, 1)
                if d >= matvec_mod.MIN_ROWS_PER_THREAD * ty * sms:
                    assert slices >= sms  # one column: the rows give the blocks


# ---------------------------------------------------------------------------
# loss_and_grad (logistic_grad)
# ---------------------------------------------------------------------------


def _logistic_error_ulps(n, dtype) -> float:
    """max |port - reference| in ulp of max(|reference|, 1), both outputs."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(n)
    s = (rng.normal(size=n) * 3).astype(np.float32)
    y = np.where(rng.normal(size=n) >= 0, 1.0, -1.0).astype(np.float32)
    want = r_ops.loss_and_grad(jnp.asarray(s, jd), jnp.asarray(y, jd), interpret=True)
    got = _unchanged_counts(
        lambda: ops.loss_and_grad(torch.from_numpy(s).to(td), torch.from_numpy(y).to(td)))
    worst = 0.0
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.dtype == torch.float32 and g.shape == (n,)
        unit = _ulp(torch.clamp_min(torch.abs(w), 1.0))
        worst = max(worst, float(torch.max(torch.abs(g - w) / unit)))
    return worst


@pytest.mark.parametrize("n", [8, 1000, 4097])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loss_and_grad_matches_reference_kernel(n, dtype):
    assert _logistic_error_ulps(n, dtype) <= LOSS_ULPS


def test_loss_and_grad_extreme_margins_stay_finite():
    s = np.asarray([-1e4, -50.0, 0.0, 50.0, 1e4], np.float32)
    y = np.ones(5, np.float32)
    loss, dloss = ops.loss_and_grad(torch.from_numpy(s), torch.from_numpy(y))
    r_loss, r_dloss = r_ops.loss_and_grad(jnp.asarray(s), jnp.asarray(y), interpret=True)
    assert bool(torch.all(torch.isfinite(loss))) and bool(torch.all(torch.isfinite(dloss)))
    assert float(loss[4]) == pytest.approx(0.0, abs=1e-6)
    assert float(dloss[0]) == pytest.approx(-1.0, abs=1e-6)
    np.testing.assert_array_equal(loss.numpy(), np.asarray(r_loss))
    np.testing.assert_array_equal(dloss.numpy(), np.asarray(r_dloss))


def test_loss_and_grad_is_the_ports_logistic_loss():
    """The fused expression computes the same function as the port's
    logaddexp / sigmoid loss (the reference's own test: 1e-5)."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy((rng.normal(size=2000) * 5).astype(np.float32))
    y = torch.from_numpy(np.where(rng.normal(size=2000) >= 0, 1.0, -1.0).astype(np.float32))
    loss, dloss = ops.loss_and_grad(s, y)
    torch.testing.assert_close(loss, t_losses.logistic.value(s, y), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dloss, t_losses.logistic.dvalue(s, y), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# svrg_dense_update (svrg_update)
# ---------------------------------------------------------------------------


def _svrg_error_ratio(d, eta, lam) -> float:
    rng = np.random.default_rng(d)
    w, g, z = (rng.normal(size=d).astype(np.float32) for _ in range(3))
    want = np.asarray(r_ops.svrg_dense_update(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(z), eta=eta, lam=lam, interpret=True))
    got = _unchanged_counts(lambda: ops.svrg_dense_update(
        torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(z), eta=eta, lam=lam))
    c, e = svrg_mod.coefficients(eta, lam)
    scale = np.abs(np.float32(c) * w) + np.abs(np.float32(e) * (g + z))
    return float(np.max(np.abs(got.numpy() - want) / (SVRG_RTOL * scale + 1e-30)))


@pytest.mark.parametrize("d", [100, 2049, 65536])
@pytest.mark.parametrize("eta,lam", [(0.1, 1e-4), (0.5, 0.0), (0.01, 1e-2)])
def test_svrg_dense_update_matches_reference_kernel(d, eta, lam):
    assert _svrg_error_ratio(d, eta, lam) <= 1.0


def test_svrg_coefficients_round_once_from_double():
    """1 - eta*lam is reckoned in double and rounded once (JAX's weak
    typing of the reference's closed-over floats), not formed in float32."""
    eta, lam = 0.3, 0.7
    c, e = svrg_mod.coefficients(eta, lam)
    assert c == float(np.float32(1.0 - eta * lam)) and e == float(np.float32(eta))
    in_f32 = float(np.float32(1.0) - np.float32(eta) * np.float32(lam))
    assert c != in_f32  # the two roundings differ at this (eta, lam)


# ---------------------------------------------------------------------------
# fused_block_update (fused_update)
# ---------------------------------------------------------------------------


def _fused_case(u, width, d, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(u, width)).astype(np.int32)
    val = rng.random((u, width)).astype(np.float32)
    idx[:, width - 3:], val[:, width - 3:] = 0, 0.0  # padding (id 0, value 0.0)
    if u > 1:
        idx[1, :3] = idx[0, :3]  # duplicate ids across sampled rows
    w = (rng.normal(size=d) * 0.01).astype(np.float32)
    z = (rng.normal(size=d) * 0.01).astype(np.float32)
    coef = rng.normal(size=u).astype(np.float32)
    return w, idx, val, coef, z


@pytest.mark.parametrize("width", NEWS20_WIDTHS)
@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("lam", [1e-4, 0.0])
def test_fused_block_update_matches_reference_kernel(width, u, lam):
    eta = 0.25
    w, idx, val, coef, z = _fused_case(u, width, 2000, seed=width * 10 + u)
    want = np.asarray(r_ops.fused_block_update(
        *[jnp.asarray(a) for a in (w, idx, val, coef, z)], jnp.float32(eta), lam=lam,
        interpret=True))
    got = _unchanged_counts(lambda: ops.fused_block_update(
        *[torch.from_numpy(a) for a in (w, idx, val, coef, z)], eta, lam=lam)).numpy()
    g = np.zeros_like(z)
    np.add.at(g, idx.reshape(-1), (val * coef[:, None]).reshape(-1))
    tol = FUSED_RTOL * (np.abs(w) + np.abs(want) + eta * np.abs(g + z)) + 1e-30
    assert np.all(np.abs(got - want) <= tol)


def test_fused_block_update_is_prox_update_without_prox():
    """The plain versions, as the kernels on the card: fused_update equals
    prox_update at lam1 = lam2 = 0 bit for bit (tests/test_fused_kernels.py:157)."""
    args = [torch.from_numpy(a) for a in _fused_case(4, 47, 500, seed=1)]
    for eta in (0.25, 0.0):
        a = ops.fused_block_update(*args, eta, lam=1e-4)
        b = ops.fused_block_prox_update(*args, eta, lam=1e-4)
        assert torch.equal(a, b)
    assert torch.equal(ops.fused_block_update(*args, 0.0, lam=1e-4), args[0])  # masked: w


# ---------------------------------------------------------------------------
# the data, and the composed step (tests/test_kernels.py:159)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim,n,seed,noise", [(640, 32, 0, 0.0), (50, 300, 3, 0.1),
                                              (1, 5, 7, 0.5)])
def test_make_dense_classification_is_byte_identical(dim, n, seed, noise):
    kw = dict(dim=dim, num_instances=n, seed=seed, label_noise=noise)
    (D, y), (rD, ry) = t_make_dense(**kw), r_make_dense(**kw)
    assert D.dtype == rD.dtype and y.dtype == ry.dtype
    assert D.tobytes() == rD.tobytes() and y.tobytes() == ry.tobytes()


def test_dense_problem_carries_the_arrays():
    D, y = t_make_dense(dim=30, num_instances=8, seed=1)
    Dt, yt = convert.dense_problem(np.asfortranarray(D), y)
    assert Dt.is_contiguous() and Dt.dtype == torch.float32 and Dt.shape == (30, 8)
    assert Dt.numpy().tobytes() == D.tobytes() and yt.numpy().tobytes() == y.tobytes()
    with pytest.raises(TypeError):
        convert.dense_problem(D.astype(np.float64), y)
    with pytest.raises(ValueError, match="want"):
        convert.dense_problem(D, y[:-1])


def _composed_step(D, y, w, eta, lam, i):
    """The composed step of tests/test_kernels.py:159, through the port."""
    n = D.shape[1]
    s0 = ops.margins_dense(w, D)
    _, dl0 = ops.loss_and_grad(s0, y)
    z = D @ (dl0 / n)
    s_m = ops.margins_dense(w, D[:, i:i + 1].contiguous())
    _, dl_m = ops.loss_and_grad(s_m, y[i:i + 1])
    g_sparse = (dl_m[0] - dl0[i]) * D[:, i]
    return ops.svrg_dense_update(w, g_sparse, z, eta=eta, lam=lam)


def _reference_composed_step(D, y, w, eta, lam, i):
    D, y, w = jnp.asarray(D), jnp.asarray(y), jnp.asarray(w)
    n = D.shape[1]
    s0 = r_ops.margins_dense(w, D, interpret=True)
    _, dl0 = r_ops.loss_and_grad(s0, y, interpret=True)
    z = D @ (dl0 / n)
    s_m = r_ops.margins_dense(w, D[:, i:i + 1], interpret=True)[0]
    _, dl_m = r_ops.loss_and_grad(s_m[None], y[i:i + 1], interpret=True)
    g_sparse = (dl_m[0] - dl0[i]) * D[:, i]
    return np.asarray(r_ops.svrg_dense_update(w, g_sparse, z, eta=eta, lam=lam, interpret=True))


def _composed_step_error_ratio() -> float:
    D, y = t_make_dense(dim=640, num_instances=32, seed=0)
    w = (np.random.default_rng(0).normal(size=640) * 0.1).astype(np.float32)
    want = _reference_composed_step(D, y, w, 0.2, 1e-3, 3)
    Dt, yt = convert.dense_problem(D, y)
    got = _composed_step(Dt, yt, convert.init_w(w), 0.2, 1e-3, 3).numpy()
    return float(np.max(np.abs(got - want)) / (STEP_RTOL * np.max(np.abs(want))))


def test_composed_svrg_step_matches_reference():
    assert _composed_step_error_ratio() <= 1.0


# ---------------------------------------------------------------------------
# wrappers and launchers, as far as the CPU can check them
# ---------------------------------------------------------------------------


def test_dense_cuda_launchers_refuse_cpu_tensors():
    w, D = torch.zeros(10), torch.zeros((10, 3))
    idx, val = torch.zeros((2, 3), dtype=torch.int32), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        matvec_mod.fd_matvec(w, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        logistic_mod.logistic_grad(w, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        svrg_mod.svrg_update(w, w, w, 0.1, 0.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mod.fused_update(w, idx, val, torch.zeros(2), w, 0.1, 0.0)


def test_dense_wrappers_refuse_unknown_devices():
    w, D = torch.zeros(4, device="meta"), torch.zeros((4, 2), device="meta")
    idx = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    calls = [
        lambda: ops.margins_dense(w, D),
        lambda: ops.loss_and_grad(w, w),
        lambda: ops.svrg_dense_update(w, w, w, eta=0.1, lam=0.0),
        lambda: ops.fused_block_update(w, idx, torch.zeros((1, 2), device="meta"),
                                       torch.zeros(1, device="meta"), w, 0.1, lam=0.0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


def test_float_codes_take_float32_and_bfloat16_only():
    assert _build.float_code("k", "x", torch.zeros(1)) == 0
    assert _build.float_code("k", "x", torch.zeros(1, dtype=torch.bfloat16)) == 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.float_code("k", "x", torch.zeros(1, dtype=torch.float64))


def test_build_never_uses_fast_math():
    """expf / logf must stay the full-precision functions (logistic_grad)."""
    assert not any("fast_math" in f or "fast-math" in f for f in _build.NVCC_FLAGS)
    text = (_build.CSRC / "logistic_grad.cu").read_text()
    code = "\n".join(ln for ln in text.splitlines() if not ln.lstrip().startswith("//"))
    assert "expf(" in code and "logf(" in code
    assert "__expf" not in code and "__logf" not in code


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(512, 256), (777, 130), (512, 1), (1, 7), (20_000, 300),
                                 (70_001, 1), (3, 1)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fd_matvec_kernel_matches_plain_on_card(cuda_device, d, n, dtype):
    td = DTYPES[dtype][1]
    rng = np.random.default_rng(d + n)
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(cuda_device, td)
    D = torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32)).to(cuda_device, td)
    got = matvec_mod.fd_matvec(w, D)
    want = matvec_mod.fd_matvec_plain(w, D)
    scale = torch.sum(torch.abs(w.float()[:, None] * D.float()), dim=0)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert bool(torch.all(torch.abs(got - want) <= 1e-5 * scale))
    assert torch.equal(got, matvec_mod.fd_matvec(w, D))  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1000, 169_399])
@pytest.mark.parametrize("n,ld", [(1, 1), (7, 7), (1, 300), (7, 300)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fd_matvec_narrow_and_strided_on_card(cuda_device, d, n, ld, dtype):
    """N = 1 and 7, contiguous and as a column view of a [d, 300] matrix
    (row stride 300): within the tolerance, deterministic, one launch."""
    td = DTYPES[dtype][1]
    rng = np.random.default_rng(d + n + ld)
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(cuda_device, td)
    wide = torch.from_numpy(rng.normal(size=(d, ld)).astype(np.float32)).to(cuda_device, td)
    D = wide[:, 3:3 + n] if ld > n else wide
    before = matvec_mod.launches
    got = matvec_mod.fd_matvec(w, D)
    torch.cuda.synchronize()
    assert matvec_mod.launches == before + 1
    want = matvec_mod.fd_matvec_plain(w, D)
    scale = torch.sum(torch.abs(w.float()[:, None] * D.float()), dim=0)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert bool(torch.all(torch.abs(got - want) <= 1e-5 * scale))
    assert torch.equal(got, matvec_mod.fd_matvec(w, D))  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 1000, 4097, 2**20 + 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_logistic_grad_kernel_matches_plain_on_card(cuda_device, n, dtype):
    td = DTYPES[dtype][1]
    rng = np.random.default_rng(n)
    s = torch.from_numpy((rng.normal(size=n) * 8).astype(np.float32)).to(cuda_device, td)
    y = torch.from_numpy(np.where(rng.normal(size=n) >= 0, 1.0, -1.0).astype(np.float32))
    y = y.to(cuda_device, td)
    for got, want in zip(logistic_mod.logistic_grad(s, y), logistic_mod.logistic_grad_plain(s, y)):
        assert got.dtype == torch.float32 and got.shape == (n,)
        assert bool(torch.all(torch.abs(got - want) <= LOSS_ULPS * _ulp(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 100, 2049, 65_537])
@pytest.mark.parametrize("eta,lam", [(0.1, 1e-4), (0.5, 0.0), (0.01, 1e-2)])
def test_svrg_update_kernel_equals_plain_on_card(cuda_device, d, eta, lam):
    rng = np.random.default_rng(d)
    w, g, z = (torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(cuda_device)
               for _ in range(3))
    assert torch.equal(svrg_mod.svrg_update(w, g, z, eta, lam),
                       svrg_mod.svrg_update_plain(w, g, z, eta, lam))


@pytest.mark.cuda
@pytest.mark.parametrize("u", [1, 8])
@pytest.mark.parametrize("lam", [1e-4, 0.0])
@pytest.mark.parametrize("eta", [0.25, 0.0])
def test_fused_update_kernel_on_card(cuda_device, u, lam, eta):
    """Bitwise against the prox_update kernel at lam1 = lam2 = 0; against
    its plain version within the touched pass's bound (index_add_ adds
    duplicate ids with atomics, in another order than the kernel's)."""
    case = _fused_case(u, 161, 20_000, seed=u)
    args = [torch.from_numpy(a).to(cuda_device) for a in case]
    got = fused_mod.fused_update(*args, eta, lam)
    assert torch.equal(got, prox_mod.prox_update(*args, eta, lam, 0.0, 0.0))
    want = fused_mod.fused_update_plain(*args, eta, lam)
    w, idx, val, coef, z = case
    g_abs = np.zeros_like(w)
    np.add.at(g_abs, idx.reshape(-1), np.abs(val * coef[:, None]).reshape(-1))
    tol = 1e-7 + 1e-6 * (np.abs(w) + np.abs(want.cpu().numpy())
                         + eta * (g_abs + np.abs(z) + lam * np.abs(w)))
    assert np.all(np.abs(got.cpu().numpy() - want.cpu().numpy()) <= tol)


@pytest.mark.cuda
def test_dense_wrappers_launch_their_kernels_on_card(cuda_device):
    D, y = t_make_dense(dim=640, num_instances=32, seed=0)
    Dt, yt = convert.dense_problem(D, y, cuda_device)
    w = convert.init_w((np.random.default_rng(0).normal(size=640) * 0.1).astype(np.float32))
    ops.reset_launch_counts()
    got = _composed_step(Dt, yt, w.to(cuda_device), 0.2, 1e-3, 3)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "fd_matvec": 2, "logistic_grad": 2, "svrg_update": 1}
    want = _composed_step(Dt.cpu(), yt.cpu(), w, 0.2, 1e-3, 3)
    assert float(torch.max(torch.abs(got.cpu() - want))) <= 1e-6 * float(torch.max(torch.abs(want)))


if __name__ == "__main__":
    # Worst error over the CPU cases, as a fraction of the stated tolerance:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dense_kernels.py
    print({
        "margins_dense": max(_matvec_error_ratio(d, n, t)
                             for d, n in [(512, 256), (1024, 512), (777, 130), (512, 1), (1, 7)]
                             for t in DTYPES),
        "loss_and_grad_ulps": max(_logistic_error_ulps(n, t) for n in (8, 1000, 4097)
                                  for t in DTYPES),
        "svrg_dense_update": max(_svrg_error_ratio(d, e, l) for d in (100, 2049, 65536)
                                 for e, l in [(0.1, 1e-4), (0.5, 0.0), (0.01, 1e-2)]),
        "composed_step": _composed_step_error_ratio(),
    })
