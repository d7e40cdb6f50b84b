"""The port's dense-step kernels, held against the reference's Pallas kernels.

On the CPU each ``repro_torch.kernels.ops`` wrapper takes its kernel's
plain PyTorch version; these tests hold that version against the
reference's kernel run in interpret mode (the way its own tests run it),
for every regularizer setting and for u in {1, 4}.  Stated tolerances:

* ``sparse_margins``: ``|d| <= 1e-6 * sum_k |w[idx] * val|`` per row;
* ``fused_block_prox_update``: ``|d| <= 1e-6 * (|want| + eta * |g + z|)``
  elementwise — one float32 rounding of the update's terms (XLA may
  contract ``w - eta * g`` into an FMA, PyTorch does not).

The CUDA kernels themselves compile only on the card: the tests marked
``cuda`` hold them against their plain versions there and skip here.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops

from repro_torch.kernels import _build, ops
from repro_torch.kernels import block_scatter as scatter_mod
from repro_torch.kernels import fd_matvec as matvec_mod
from repro_torch.kernels import flash_decode as decode_mod
from repro_torch.kernels import fused_update as fused_mod
from repro_torch.kernels import lazy_update as lazy_mod
from repro_torch.kernels import logistic_grad as logistic_mod
from repro_torch.kernels import prox_update as prox_mod
from repro_torch.kernels import sparse_margin as margin_mod
from repro_torch.kernels import svrg_update as svrg_mod

MARGIN_RTOL = 1e-6
PROX_RTOL = 1e-6
# news20 per-block nnz budgets at q = 8, and the q = 1 width.
NEWS20_WIDTHS = [161, 75, 75, 93, 69, 109, 47, 72, 455]
REG_SETTINGS = {
    "l2": (1e-4, 0.0, 0.0),
    "l1": (0.0, 1e-5, 0.0),
    "elastic_net": (0.0, 1e-3, 1e-2),
    "none": (0.0, 0.0, 0.0),
}


def _rows(rng, rows, width, d, pad=3):
    idx = rng.integers(0, d, size=(rows, width)).astype(np.int32)
    val = rng.random((rows, width)).astype(np.float32)
    idx[:, width - pad:] = 0  # trailing padding: (local id 0, value 0.0)
    val[:, width - pad:] = 0.0
    return idx, val


def _margin_error_ratio(width) -> float:
    """max_i |port - reference| / (1e-6 * sum_k |w[idx] * val|)."""
    rng = np.random.default_rng(width)
    d = 3000
    idx, val = _rows(rng, 40, width, d)
    w = rng.normal(size=d).astype(np.float32)
    want = np.asarray(
        r_ops.sparse_margins(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(w), interpret=True)
    )
    before = ops.launch_counts()
    got = ops.sparse_margins(torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(w))
    assert ops.launch_counts() == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (40,)
    scale = np.sum(np.abs(w[idx] * val), axis=-1)
    return float(np.max(np.abs(got.numpy() - want) / (MARGIN_RTOL * scale)))


@pytest.mark.parametrize("width", NEWS20_WIDTHS)
def test_sparse_margins_match_reference_kernel(width):
    assert _margin_error_ratio(width) <= 1.0


def test_sparse_margin_padding_is_inert():
    rng = np.random.default_rng(0)
    idx, val = _rows(rng, 5, 12, 50, pad=0)
    w = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    padded_idx = np.concatenate([idx, np.zeros((5, 4), np.int32)], axis=1)
    padded_val = np.concatenate([val, np.zeros((5, 4), np.float32)], axis=1)
    a = ops.sparse_margins(torch.from_numpy(idx), torch.from_numpy(val), w)
    b = ops.sparse_margins(torch.from_numpy(padded_idx), torch.from_numpy(padded_val), w)
    # A wider row may be summed in another order: equal up to the margin
    # tolerance, not bitwise.
    scale = np.sum(np.abs(w.numpy()[idx] * val), axis=-1)
    assert np.all(np.abs(a.numpy() - b.numpy()) <= MARGIN_RTOL * scale)


def _prox_case(u, width, d, seed, dup=True):
    rng = np.random.default_rng(seed)
    idx, val = _rows(rng, u, width, d)
    if dup and u > 1:
        idx[1, :3] = idx[0, :3]  # duplicate ids across sampled rows
    w = (rng.normal(size=d) * 0.01).astype(np.float32)
    w[:5] = 0.0
    z = (rng.normal(size=d) * 0.01).astype(np.float32)
    coef = rng.normal(size=u).astype(np.float32)
    return w, idx, val, coef, z


def _prox_tolerance(want, idx, val, coef, z, eta):
    g = np.zeros_like(z)
    np.add.at(g, idx.reshape(-1), (val * coef[:, None]).reshape(-1))
    return PROX_RTOL * (np.abs(want) + eta * np.abs(g + z)) + 1e-30


def _prox_error_ratio(u, reg) -> float:
    """max |port - reference| / the stated elementwise tolerance."""
    lam, lam1, lam2 = REG_SETTINGS[reg]
    w, idx, val, coef, z = _prox_case(u, 47, 700, seed=u * 10 + len(reg))
    want = np.asarray(
        r_ops.fused_block_prox_update(
            jnp.asarray(w), jnp.asarray(idx), jnp.asarray(val), jnp.asarray(coef),
            jnp.asarray(z), jnp.float32(0.25), lam=lam, lam1=lam1, lam2=lam2, interpret=True,
        )
    )
    before = ops.launch_counts()
    got = ops.fused_block_prox_update(
        *[torch.from_numpy(a) for a in (w, idx, val, coef, z)], 0.25,
        lam=lam, lam1=lam1, lam2=lam2,
    )
    assert ops.launch_counts() == before
    return float(np.max(np.abs(got.numpy() - want)
                        / _prox_tolerance(want, idx, val, coef, z, 0.25)))


@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("reg", list(REG_SETTINGS))
def test_prox_update_matches_reference_kernel(u, reg):
    assert _prox_error_ratio(u, reg) <= 1.0


def test_prox_update_l2_path_reproduces_reference_fused_update():
    """lam1 = lam2 = 0 is the reference's fused_update (kernel 3 of the
    inventory, ported as kernels/fused_update.py): the port's prox_update
    must compute it."""
    w, idx, val, coef, z = _prox_case(4, 6, 256, seed=2)
    want = np.asarray(
        r_ops.fused_block_update(
            jnp.asarray(w), jnp.asarray(idx), jnp.asarray(val), jnp.asarray(coef),
            jnp.asarray(z), jnp.float32(0.1), lam=1e-3, interpret=True,
        )
    )
    got = ops.fused_block_prox_update(
        torch.from_numpy(w), torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(coef), torch.from_numpy(z), 0.1, lam=1e-3,
    ).numpy()
    assert np.all(np.abs(got - want) <= _prox_tolerance(want, idx, val, coef, z, 0.1))


@pytest.mark.parametrize("reg", list(REG_SETTINGS))
def test_prox_update_masked_step_is_identity(reg):
    """eta * mask = 0 (Option II tail): w comes back unchanged."""
    lam, lam1, lam2 = REG_SETTINGS[reg]
    w, idx, val, coef, z = _prox_case(3, 5, 100, seed=9)
    got = ops.fused_block_prox_update(
        torch.from_numpy(w), torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(coef), torch.from_numpy(z), 0.0, lam=lam, lam1=lam1, lam2=lam2,
    )
    np.testing.assert_array_equal(got.numpy(), w)


def test_prox_update_scatter_is_flat_order_index_add():
    """The plain version's scatter is index_add_ in flat order: duplicates
    across rows accumulate exactly as the reference's .at[].add."""
    w, idx, val, coef, z = _prox_case(4, 9, 30, seed=5)
    contrib = (val * coef[:, None]).reshape(-1)
    g = jax.jit(lambda i, c: jnp.zeros(30, jnp.float32).at[i].add(c))(
        jnp.asarray(idx.reshape(-1)), jnp.asarray(contrib))
    got = torch.zeros(30).index_add_(0, torch.from_numpy(idx.reshape(-1)),
                                     torch.from_numpy(contrib))
    assert np.asarray(g).tobytes() == got.numpy().tobytes()


def test_eta_is_rounded_to_float32():
    w, idx, val, coef, z = _prox_case(1, 4, 20, seed=1)
    args = [torch.from_numpy(a) for a in (w, idx, val, coef)]
    a = ops.fused_block_prox_update(*args, torch.from_numpy(z), 0.1, lam=0.0, lam1=1e-2)
    b = ops.fused_block_prox_update(*args, torch.from_numpy(z), float(np.float32(0.1)),
                                    lam=0.0, lam1=1e-2)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# wrappers, counters and the build, as far as the CPU can check them
# ---------------------------------------------------------------------------


def test_cuda_launchers_refuse_cpu_tensors():
    w = torch.zeros(10)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    val = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        margin_mod.sparse_margin(idx, val, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        prox_mod.prox_update(w, idx, val, torch.zeros(2), w, 0.1, 0.0, 0.0, 0.0)


def test_ops_refuses_unknown_devices():
    w = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.sparse_margins(torch.zeros((1, 1), dtype=torch.int32, device="meta"),
                           torch.zeros((1, 1), device="meta"), w)


def test_launch_counters_reset():
    margin_mod.launches, prox_mod.launches = 5, 7
    for k, name in enumerate(lazy_mod.launches):
        lazy_mod.launches[name] = k + 1
    fused_mod.launches, matvec_mod.launches = 8, 9
    logistic_mod.launches, svrg_mod.launches = 10, 11
    decode_mod.launches, scatter_mod.launches = 12, 13
    assert ops.launch_counts() == {
        "sparse_margin": 5, "block_scatter": 13, "prox_update": 7, "lazy_catchup": 1,
        "lazy_touch_update": 2, "lazy_flush": 3, "lazy_proba_update": 4,
        "fused_update": 8, "fd_matvec": 9, "logistic_grad": 10, "svrg_update": 11,
        "flash_decode": 12,
    }
    ops.reset_launch_counts()
    assert ops.launch_counts() == {
        "sparse_margin": 0, "block_scatter": 0, "prox_update": 0, "lazy_catchup": 0,
        "lazy_touch_update": 0, "lazy_flush": 0, "lazy_proba_update": 0,
        "fused_update": 0, "fd_matvec": 0, "logistic_grad": 0, "svrg_update": 0,
        "flash_decode": 0,
    }


def test_kernel_sources_declare_their_c_entry_points_and_origin():
    names = [s.name for s in _build.sources()]
    assert names == ["block_scatter.cu", "fd_matvec.cu", "flash_decode.cu", "fused_update.cu",
                     "lazy_update.cu", "logistic_grad.cu", "prox_update.cu", "sparse_margin.cu",
                     "svrg_update.cu"]
    assert [h.name for h in _build.headers()] == ["touched.cuh"]
    text = {s.name: s.read_text() for s in _build.sources() + _build.headers()}
    entries = [e for e, _, _ in _build._SIGNATURES]
    assert entries == ["repro_sparse_margin", "repro_block_scatter", "repro_prox_update", "repro_lazy_catchup",
                       "repro_lazy_touch_update", "repro_lazy_flush",
                       "repro_lazy_proba_update", "repro_fd_matvec", "repro_logistic_grad",
                       "repro_svrg_update", "repro_fused_update", "repro_flash_decode"]
    for entry, _, argtypes in _build._SIGNATURES:
        src = next(t for t in text.values() if f'extern "C" int {entry}(' in t)
        params = re.search(rf"{entry}\((.*?)\)\s*{{", src, re.S).group(1)
        assert params.count(",") + 1 == len(argtypes), entry
    assert "repro/kernels/sparse_margin.py" in text["sparse_margin.cu"]
    assert "repro/kernels/prox_update.py" in text["prox_update.cu"]
    # The port's own kernel: the reference's scatter is a plain .at[].add.
    assert "repro/data/block_csr.py" in text["block_scatter.cu"]
    assert "the pallas_call at" not in text["block_scatter.cu"]
    for line in (":125", ":177", ":224", ":266"):
        assert f"lazy_update.py{line}" in text["lazy_update.cu"]
    for name, line in (("fused_update", 73), ("fd_matvec", 61), ("logistic_grad", 46),
                       ("svrg_update", 49), ("flash_decode", 97)):
        assert f"repro/kernels/{name}.py" in text[f"{name}.cu"]
        assert f"the pallas_call at :{line}" in text[f"{name}.cu"]
    # The touched pass lives once, in the header the three kernels include.
    for name in ("prox_update.cu", "lazy_update.cu", "fused_update.cu"):
        assert '#include "touched.cuh"' in text[name]
        assert "__ballot_sync" not in text[name]
    for src in text.values():
        includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
        assert includes and not any("torch" in ln or "ATen" in ln for ln in includes)


def test_build_flags_and_hash(monkeypatch, tmp_path):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_text(src.read_text() + "\n// changed\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.source_hash() != h
    assert _build.library_path().name.endswith(f"_{_build.source_hash()}.so")


def test_source_hash_covers_the_headers(monkeypatch, tmp_path):
    """A change to a header alone names a new library: a stale build of
    the sources that include it is never loaded."""
    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    h = _build.source_hash()
    header = tmp_path / "touched.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    assert _build.source_hash() != h
    # The header is hashed but never compiled on its own.
    assert [p.name for p in _build.sources()] == \
        ["block_scatter.cu", "fd_matvec.cu", "flash_decode.cu", "fused_update.cu",
         "lazy_update.cu", "logistic_grad.cu", "prox_update.cu", "sparse_margin.cu",
         "svrg_update.cu"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("an nvcc is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_failed_launch_raises():
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "prox_update")
    _build.check(0, "prox_update")


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", NEWS20_WIDTHS)
def test_sparse_margin_kernel_matches_plain_on_card(cuda_device, width):
    rng = np.random.default_rng(width)
    idx, val = _rows(rng, 257, width, 5000)
    w = torch.from_numpy(rng.normal(size=5000).astype(np.float32)).to(cuda_device)
    idx_t, val_t = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(val).to(cuda_device)
    got = ops.sparse_margins(idx_t, val_t, w)
    want = margin_mod.sparse_margin_plain(idx_t, val_t, w)
    scale = torch.sum(torch.abs(w[idx_t] * val_t), -1)
    assert bool(torch.all(torch.abs(got - want) <= MARGIN_RTOL * scale))


@pytest.mark.cuda
@pytest.mark.parametrize("u", [1, 8])
@pytest.mark.parametrize("reg", list(REG_SETTINGS))
def test_prox_update_kernel_matches_plain_on_card(cuda_device, u, reg):
    lam, lam1, lam2 = REG_SETTINGS[reg]
    args = [torch.from_numpy(a).to(cuda_device) for a in _prox_case(u, 161, 20_000, seed=u)]
    got = prox_mod.prox_update(*args, 0.25, lam, lam1, lam2)
    want = prox_mod.prox_update_plain(*args, 0.25, lam, lam1, lam2)
    if u == 1:
        assert torch.equal(got, want)
    else:
        assert bool(torch.all(torch.abs(got - want) <= 1e-7 + PROX_RTOL * torch.abs(want)))


TOUCHED_KERNELS = {"prox_update": prox_mod, "fused_update": fused_mod,
                   "lazy_touch_update": lazy_mod, "lazy_proba_update": lazy_mod}
TOUCHED_RANGE = 2048  # features one block of the touched pass owns (csrc/touched.cuh)


def _touched_case(u, seed, d, width=161):
    """Rows as news20 block 0 gives them: 80 copies of a hot id a row,
    ids at the first and last feature of the touched pass's block ranges,
    ids repeated across rows (row 0's in the last row too: one owner,
    terms in two blocks' positions of the lazy grid), and trailing padding
    (id 0, value 0.0)."""
    rng = np.random.default_rng(seed)
    idx, val = _rows(rng, u, width, d, pad=20)
    idx[:, 5:85] = 12_539
    edges = [0, 1, TOUCHED_RANGE - 1, TOUCHED_RANGE, 2 * TOUCHED_RANGE - 1, d - 1]
    idx[:, 85:85 + len(edges)] = edges
    if u > 1:
        idx[1:, 100:104] = idx[0, 100:104]
        idx[-1, 110:130] = idx[0, 110:130]
    w = (rng.normal(size=d) * 0.01).astype(np.float32)
    z = (rng.normal(size=d) * 0.01).astype(np.float32)
    coef = rng.normal(size=u).astype(np.float32)
    corr = rng.uniform(1.0, 20.0, size=d).astype(np.float32)
    return w, idx, val, coef, z, corr


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(TOUCHED_KERNELS))
@pytest.mark.parametrize("u", [1, 8, 64])
@pytest.mark.parametrize("reg", list(REG_SETTINGS))
@pytest.mark.parametrize("d", [20_000, 2_000_000])
def test_touched_kernels_equal_cpu_plain_bitwise_on_card(cuda_device, kernel, u, reg, d):
    """The four kernels of the touched pass equal their plain versions on
    the CPU (whose index_add_ adds in flat order) bit for bit, twice; u = 64
    gives 10,304 entries, past one staged window.  The lazy kernels' grid
    is sized to the entries (256 flat positions a block), not to d; at d =
    2,000,000 the ids spread over the whole block.  fused_update takes the
    setting's smooth lam only."""
    lam, lam1, lam2 = REG_SETTINGS[reg]
    case = _touched_case(u, seed=u, d=d)
    mod = TOUCHED_KERNELS[kernel]

    def call(fn, dev):
        w, idx, val, coef, z, corr = (torch.from_numpy(a.copy()).to(dev) for a in case)
        if kernel == "fused_update":
            return fn(w, idx, val, coef, z, 0.25, lam)
        if kernel == "lazy_proba_update":
            return fn(w, idx, val, coef, z, corr, 0.25, lam, lam1, lam2)
        return fn(w, idx, val, coef, z, 0.25, lam, lam1, lam2)

    want = call(getattr(mod, kernel + "_plain"), "cpu").numpy().view(np.int32)
    for _ in range(2):
        got = call(getattr(mod, kernel), cuda_device)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy().view(np.int32), want)


if __name__ == "__main__":
    # Worst error over the CPU cases, as a fraction of the stated tolerance:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_kernels.py
    print({
        "sparse_margins": max(_margin_error_ratio(w) for w in NEWS20_WIDTHS),
        "fused_block_prox_update": max(
            _prox_error_ratio(u, reg) for u in (1, 4) for reg in REG_SETTINGS),
    })
