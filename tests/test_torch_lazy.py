"""The port's lazy inner steps and executable spec, held against the reference.

Inputs are made from a seed with numpy and fed to both packages.

Kernels (``repro_torch.kernels.lazy_update``): on the CPU each
``ops.lazy_block_*`` wrapper takes its kernel's plain version, held
against the reference's Pallas kernel run in interpret mode (as the
reference's own tests run it) and against its ``ref.lazy_*_ref``, for the
four regularizers, masked and unmasked eta, u in {1, 4}, duplicate ids
and the padding collision at local id 0.  ``last`` must match exactly.
Stated float tolerances (XLA contracts ``w - eta*g`` into an FMA, PyTorch
does not, so each step may differ by a rounding):

* catch-up and flush: ``|d| <= 1e-6 * (k + 1) * (|w| + |want| + eta*|z|)``
  per feature, k the number of steps it replays;
* touch and proba: ``|d| <= 1e-6 * (|w| + |want| + eta * (|g| + c*(|z| +
  lam*|w|) + c*lam1))`` per touched feature, g the feature's summed
  contribution and c its correction (1 for touch);
* ``step_corrections``: rtol 1e-6.

Drivers, port against reference, as slice 1: meters and ``comm_*``
exact, objectives rtol 1e-5, ``w`` atol 1e-5.  Inside the port,
``lazy_updates="exact"`` equals ``lazy_updates=None`` bit for bit, and
the executable spec equals ``run_fdsvrg`` bit for bit.

The ``cuda``-marked tests hold each CUDA kernel against its plain version
on a card and skip here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fdsvrg as r_fdsvrg
from repro.core import losses as r_losses
from repro.core.partition import balanced as r_balanced
from repro.data.synthetic import make_sparse_classification as r_make
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref

from repro_torch.core import fdsvrg as t_fdsvrg
from repro_torch.core import losses as t_losses
from repro_torch.core.partition import balanced as t_balanced
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.sparse import PaddedCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.kernels import _build
from repro_torch.kernels import lazy_update as lazy_mod
from repro_torch.kernels import ops

RTOL = 1e-6
OBJ_RTOL = 1e-5
W_ATOL = 1e-5
# (lam, lam1, lam2) of each regularizer setting, as the kernels take them.
LAMS = {
    "l2": (1e-3, 0.0, 0.0),
    "l1": (0.0, 1e-3, 0.0),
    "elastic_net": (0.0, 1e-3, 1e-2),
    "none": (0.0, 0.0, 0.0),
}
REGS = {"l2": (1e-3, 0.0), "l1": (1e-3, 0.0), "elastic_net": (1e-3, 1e-2), "none": (0.0, 0.0)}
D, STEPS = 300, 9


def _case(seed, u, nnz=6):
    """A block of D features: rows with duplicate ids across and within
    rows, and trailing padding (id 0, value 0.0) colliding with a genuine
    id-0 entry."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=D).astype(np.float32)
    w[:3] = 0.0
    last = rng.integers(0, STEPS, size=D).astype(np.int32)
    z = (rng.normal(size=D) * 0.5).astype(np.float32)
    idx = rng.integers(1, D, size=(u, nnz)).astype(np.int32)
    val = rng.normal(size=(u, nnz)).astype(np.float32)
    idx[0, 0], idx[0, 1] = 0, idx[0, 2]  # genuine id 0; a duplicate in the row
    idx[-1, -2:], val[-1, -2:] = 0, 0.0  # padding
    if u > 1:
        idx[1, :2] = idx[0, 2:4]  # duplicates across rows
    coef = rng.normal(size=u).astype(np.float32)
    corr = rng.uniform(1.0, 20.0, size=D).astype(np.float32)
    return w, last, z, idx, val, coef, corr


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _ratio(got, want, tol) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / (tol + 1e-30)))


# ---------------------------------------------------------------------------
# the four plain versions vs the reference's Pallas kernels and refs
# ---------------------------------------------------------------------------


CATCHUP_STEPS = {"unmasked": (7, 8), "masked tail": (7, 4)}  # (m, stop)


def _catchup_ratio(reg, u, steps) -> float:
    lam, lam1, lam2 = LAMS[reg]
    w, last, z, idx, *_ = _case(u, u)
    m, stop = CATCHUP_STEPS[steps]
    eta = 0.1
    pallas = r_ops.lazy_block_catchup(*_j(w, last, z, idx), eta, m, stop, lam=jnp.float32(lam),
                                      lam1=lam1, lam2=lam2, interpret=True)
    ref = jax.jit(r_ref.lazy_catchup_ref, static_argnames=("lam1", "lam2"))(
        *_j(w, last, z, idx), jnp.float32(eta), jnp.int32(m), jnp.int32(stop),
        lam=jnp.float32(lam), lam1=lam1, lam2=lam2)
    tw, tlast = _t(w, last)
    before = ops.launch_counts()
    got_w, got_last = ops.lazy_block_catchup(tw, tlast, *_t(z, idx), eta, m, stop,
                                             lam=lam, lam1=lam1, lam2=lam2)
    assert ops.launch_counts() == before  # the CPU takes the plain version
    assert got_w is tw and got_last is tlast  # in place
    k = np.maximum(min(stop, m) - last, 0) + 1
    tol = RTOL * k * (np.abs(w) + np.abs(np.asarray(ref[0])) + eta * np.abs(z))
    for _, want_last in (pallas, ref):
        np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))
    touched = np.unique(idx)
    np.testing.assert_array_equal(np.delete(got_w.numpy(), touched), np.delete(w, touched))
    return max(_ratio(got_w, pallas[0], tol), _ratio(got_w, ref[0], tol))


@pytest.mark.parametrize("steps", list(CATCHUP_STEPS))
@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("reg", list(LAMS))
def test_lazy_catchup_matches_reference(reg, u, steps):
    assert _catchup_ratio(reg, u, steps) <= 1.0


def _touch_tol(w, want, idx, val, coef, z, corr, eta, lam, lam1):
    g = np.zeros(D, np.float32)
    np.add.at(g, idx.reshape(-1), np.abs(val * coef[:, None]).reshape(-1))
    return RTOL * (np.abs(w) + np.abs(want)
                   + eta * (g + corr * (np.abs(z) + lam * np.abs(w)) + corr * lam1))


def _touch_ratio(reg, u, eta) -> float:
    lam, lam1, lam2 = LAMS[reg]
    w, _, z, idx, val, coef, _ = _case(10 + u, u)
    pallas = r_ops.lazy_block_touch_update(*_j(w, idx, val, coef, z), eta, lam=lam,
                                           lam1=lam1, lam2=lam2, interpret=True)
    ref = jax.jit(r_ref.lazy_touch_update_ref, static_argnames=("lam", "lam1", "lam2"))(
        *_j(w, idx, val, coef, z), jnp.float32(eta), lam=lam, lam1=lam1, lam2=lam2)
    tw = torch.from_numpy(w.copy())
    got = ops.lazy_block_touch_update(tw, *_t(idx, val, coef, z), eta, lam=lam, lam1=lam1,
                                      lam2=lam2)
    assert got is tw
    tol = _touch_tol(w, np.asarray(ref), idx, val, coef, z, np.ones(D, np.float32), eta, lam,
                     lam1)
    return max(_ratio(got, pallas, tol), _ratio(got, ref, tol))


@pytest.mark.parametrize("eta", [0.1, 0.0])
@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("reg", list(LAMS))
def test_lazy_touch_update_matches_reference(reg, u, eta):
    assert _touch_ratio(reg, u, eta) <= 1.0


FLUSH_STEPS = {"option I": (STEPS, STEPS), "option II": (STEPS, 5)}  # (total, stop)


def _flush_ratio(reg, option) -> float:
    lam, lam1, lam2 = LAMS[reg]
    w, last, z, *_ = _case(20, 1)
    total, stop = FLUSH_STEPS[option]
    eta = 0.1
    pallas = r_ops.lazy_block_flush(*_j(w, last, z), eta, total, stop, lam=jnp.float32(lam),
                                    lam1=lam1, lam2=lam2, interpret=True)
    ref = jax.jit(r_ref.lazy_flush_ref, static_argnames=("lam1", "lam2"))(
        *_j(w, last, z), jnp.float32(eta), jnp.int32(total), jnp.int32(stop),
        lam=jnp.float32(lam), lam1=lam1, lam2=lam2)
    tw, tlast = _t(w, last)
    got = ops.lazy_block_flush(tw, tlast, torch.from_numpy(z), eta, total, stop, lam=lam,
                               lam1=lam1, lam2=lam2)
    assert got is tw and np.array_equal(tlast.numpy(), last)
    k = np.maximum(min(stop, total) - last, 0) + 1
    tol = RTOL * k * (np.abs(w) + np.abs(np.asarray(ref)) + eta * np.abs(z))
    return max(_ratio(got, pallas, tol), _ratio(got, ref, tol))


@pytest.mark.parametrize("option", list(FLUSH_STEPS))
@pytest.mark.parametrize("reg", list(LAMS))
def test_lazy_flush_matches_reference(reg, option):
    assert _flush_ratio(reg, option) <= 1.0


def _proba_ratio(reg, u, eta) -> float:
    lam, lam1, lam2 = LAMS[reg]
    w, _, z, idx, val, coef, corr = _case(30 + u, u)
    pallas = r_ops.lazy_block_proba_update(*_j(w, idx, val, coef, z, corr), eta, lam=lam,
                                           lam1=lam1, lam2=lam2, interpret=True)
    ref = jax.jit(r_ref.lazy_proba_update_ref, static_argnames=("lam", "lam1", "lam2"))(
        *_j(w, idx, val, coef, z, corr), jnp.float32(eta), lam=lam, lam1=lam1, lam2=lam2)
    tw = torch.from_numpy(w.copy())
    got = ops.lazy_block_proba_update(tw, *_t(idx, val, coef, z, corr), eta, lam=lam,
                                      lam1=lam1, lam2=lam2)
    assert got is tw
    tol = _touch_tol(w, np.asarray(ref), idx, val, coef, z, corr, eta, lam, lam1)
    return max(_ratio(got, pallas, tol), _ratio(got, ref, tol))


@pytest.mark.parametrize("eta", [0.1, 0.0])
@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("reg", list(LAMS))
def test_lazy_proba_update_matches_reference(reg, u, eta):
    assert _proba_ratio(reg, u, eta) <= 1.0


def test_masked_touch_and_catchup_leave_untouched_features_alone():
    """eta * mask = 0 moves no feature outside the touched set, and the
    catch-up replays each duplicated id once (its first occurrence)."""
    w, last, z, idx, val, coef, _ = _case(5, 4)
    tw = torch.from_numpy(w.copy())
    ops.lazy_block_touch_update(tw, *_t(idx, val, coef, z), 0.0, lam=1e-3)
    touched = np.unique(idx)
    np.testing.assert_array_equal(np.delete(tw.numpy(), touched), np.delete(w, touched))
    once = _t(w, last)
    ops.lazy_block_catchup(*once, *_t(z, idx), 0.1, 7, 8, lam=1e-3)
    twice_idx = np.concatenate([idx, idx], axis=0)
    dup = _t(w, last)
    ops.lazy_block_catchup(*dup, *_t(z, twice_idx), 0.1, 7, 8, lam=1e-3)
    assert torch.equal(once[0], dup[0]) and torch.equal(once[1], dup[1])


def test_step_corrections_match_reference():
    rng = np.random.default_rng(0)
    nnz_col = rng.integers(0, 9, size=200).astype(np.int32)
    nnz_col[:3] = [0, 1, 8]
    for u in (1, 2, 4):
        want = np.asarray(r_ops.step_corrections(jnp.asarray(nnz_col), 8, u))
        got = ops.step_corrections(torch.from_numpy(nnz_col), 8, u)
        assert got.dtype == torch.float32 and got[0] == 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# ---------------------------------------------------------------------------
# drivers: port vs reference
# ---------------------------------------------------------------------------

DATA = dict(dim=400, num_instances=64, nnz_per_instance=8, seed=3)
# Every (variant, q, reg) once; Options I/II, u in {1, 2} and both port
# paths alternate over the matrix.
DRIVER_MATRIX = [
    (variant, q, reg, ("I", "II")[(i + j) % 2], (1, 2)[j % 2], (True, False)[(i + j + k) % 2])
    for k, variant in enumerate(("exact", "proba"))
    for i, q in enumerate((1, 3))
    for j, reg in enumerate(REGS)
]


@functools.lru_cache(maxsize=None)
def _data():
    return r_make(**DATA), t_make(**DATA)


def _cfgs(option, u, m=12, outers=2):
    kw = dict(eta=0.2, inner_steps=m, outer_iters=outers, batch_size=u, option=option,
              seed=5)
    return r_fdsvrg.SVRGConfig(**kw), t_fdsvrg.SVRGConfig(**kw)


def _regs(reg):
    lam, lam2 = REGS[reg]
    return r_losses.Regularizer(reg, lam, lam2), t_losses.Regularizer(reg, lam, lam2)


def _run_errors(ref, port) -> dict:
    obj, r_obj = port.objectives(), ref.objectives()
    return {"objective_rel": float(np.max(np.abs(obj - r_obj) / np.abs(r_obj))),
            "w_abs": float(np.max(np.abs(port.w.numpy() - np.asarray(ref.w))))}


def _assert_runs_agree(ref, port):
    err = _run_errors(ref, port)
    assert err["objective_rel"] <= OBJ_RTOL and err["w_abs"] <= W_ATOL, err
    for field in ("outer", "comm_scalars", "comm_rounds", "modeled_time_s"):
        assert [getattr(h, field) for h in port.history] == \
            [getattr(h, field) for h in ref.history], field
    assert port.meter.state_dict() == ref.meter.state_dict()


def _fd_pair(variant, q, reg, option, u, use_kernels):
    r_data, t_data = _data()
    rcfg, tcfg = _cfgs(option, u)
    r_reg, t_reg = _regs(reg)
    ref = r_fdsvrg.run_fdsvrg(r_data, r_balanced(r_data.dim, q), r_losses.logistic, r_reg,
                              rcfg, lazy_updates=variant)
    port = t_fdsvrg.run_fdsvrg(t_data, t_balanced(t_data.dim, q), t_losses.logistic, t_reg,
                               tcfg, use_kernels=use_kernels, lazy_updates=variant,
                               device="cpu")
    return ref, port


@pytest.mark.parametrize("variant,q,reg,option,u,use_kernels", DRIVER_MATRIX)
def test_lazy_fdsvrg_matches_reference(variant, q, reg, option, u, use_kernels):
    ref, port = _fd_pair(variant, q, reg, option, u, use_kernels)
    _assert_runs_agree(ref, port)
    assert port.history[-1].objective < np.log(2.0)


@pytest.mark.parametrize("variant", ["exact", "proba"])
@pytest.mark.parametrize("reg", list(REGS))
def test_lazy_serial_matches_reference(reg, variant):
    r_data, t_data = _data()
    rcfg, tcfg = _cfgs("II", 2)
    r_reg, t_reg = _regs(reg)
    ref = r_fdsvrg.run_serial_svrg(r_data, r_losses.logistic, r_reg, rcfg,
                                   lazy_updates=variant)
    port = t_fdsvrg.run_serial_svrg(t_data, t_losses.logistic, t_reg, tcfg,
                                    lazy_updates=variant, device="cpu")
    _assert_runs_agree(ref, port)
    assert port.meter.total_scalars == 0


# ---------------------------------------------------------------------------
# inside the port: exact lazy == dense, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option", ["I", "II"])
@pytest.mark.parametrize("reg", list(REGS))
@pytest.mark.parametrize("q", [1, 3, 8])
def test_exact_lazy_equals_dense_bitwise(q, reg, option):
    _, t_data = _data()
    _, tcfg = _cfgs(option, 2)
    _, t_reg = _regs(reg)
    part = t_balanced(t_data.dim, q)
    for use_kernels in (True, False):
        dense = t_fdsvrg.run_fdsvrg(t_data, part, t_losses.logistic, t_reg, tcfg,
                                    use_kernels=use_kernels, device="cpu")
        lazy = t_fdsvrg.run_fdsvrg(t_data, part, t_losses.logistic, t_reg, tcfg,
                                   use_kernels=use_kernels, lazy_updates="exact",
                                   device="cpu")
        assert torch.equal(lazy.w, dense.w), (use_kernels, lazy.w.sub(dense.w).abs().max())
        assert lazy.objectives().tolist() == dense.objectives().tolist()
        assert lazy.meter.state_dict() == dense.meter.state_dict()


def test_exact_lazy_epoch_moves_never_touched_features_like_dense():
    """Features no sampled row touches see only the flush, and still follow
    the dense decay; the Option II tail is replayed as one masked step."""
    _, t_data = _data()
    bd = BlockCSR.from_padded(t_data, t_balanced(t_data.dim, 3))
    rng = np.random.default_rng(1)
    w0 = torch.from_numpy(rng.normal(size=t_data.dim).astype(np.float32))
    w_in = w0.clone()
    reg = t_losses.Regularizer("elastic_net", 1e-3, 1e-2)
    z, s0 = t_fdsvrg._full_grad_blocks(bd, w0, t_losses.logistic, use_kernels=True)
    samples = np.array([[0], [1], [0]], dtype=np.int32)
    mask = np.array([1.0, 1.0, 0.0], dtype=np.float32)
    dense = t_fdsvrg._inner_epoch(bd, w0, z, s0, samples, 0.2, mask, t_losses.logistic, reg,
                                  True)
    lazy = t_fdsvrg._lazy_inner_epoch(bd, w0, z, s0, samples, 0.2, mask, None,
                                      t_losses.logistic, reg, True, "exact")
    assert torch.equal(lazy, dense)
    assert not torch.equal(lazy, w0) and torch.equal(w0, w_in)  # w0 is not written


# ---------------------------------------------------------------------------
# the executable spec
# ---------------------------------------------------------------------------

SPEC_CASES = [
    (None, 3, "l2", True), (None, 3, "elastic_net", False),
    ("exact", 3, "l1", True), ("exact", 1, "none", False),
    ("proba", 3, "elastic_net", True), ("proba", 3, "l2", False),
]


@pytest.mark.parametrize("lazy,q,reg,use_kernels", SPEC_CASES)
def test_worker_simulation_matches_reference_and_run_fdsvrg(lazy, q, reg, use_kernels):
    r_data, t_data = _data()
    rcfg, tcfg = _cfgs("II", 2, m=8)
    r_reg, t_reg = _regs(reg)
    ref = r_fdsvrg.fdsvrg_worker_simulation(r_data, r_balanced(r_data.dim, q),
                                            r_losses.logistic, r_reg, rcfg,
                                            lazy_updates=lazy)
    part = t_balanced(t_data.dim, q)
    sim = t_fdsvrg.fdsvrg_worker_simulation(t_data, part, t_losses.logistic, t_reg, tcfg,
                                            use_kernels=use_kernels, lazy_updates=lazy,
                                            device="cpu")
    _assert_runs_agree(ref, sim)
    # FD == serial inside the port: the spec and run_fdsvrg, bit for bit.
    fd = t_fdsvrg.run_fdsvrg(t_data, part, t_losses.logistic, t_reg, tcfg,
                             use_kernels=use_kernels, lazy_updates=lazy, device="cpu")
    assert torch.equal(sim.w, fd.w)
    assert sim.objectives().tolist() == fd.objectives().tolist()
    assert sim.meter.total_scalars == fd.meter.total_scalars


def test_worker_simulation_rejects_unknown_variant():
    _, t_data = _data()
    _, tcfg = _cfgs("I", 1)
    with pytest.raises(ValueError, match="lazy_updates"):
        t_fdsvrg.fdsvrg_worker_simulation(t_data, t_balanced(t_data.dim, 2),
                                          t_losses.logistic, t_losses.no_reg(), tcfg,
                                          lazy_updates="nope", device="cpu")


# ---------------------------------------------------------------------------
# a step's touched pass over all q blocks
# ---------------------------------------------------------------------------

TOUCH_ETA = 0.2


@functools.lru_cache(maxsize=None)
def _touch_layout(rows: str, q: int) -> BlockCSR:
    """256 rows of 120 ids over 60,013 features, cut into q blocks; each
    block's rows padded to its budget with (local id 0, value 0.0).
    "zipf": the benchmark's rows, each id once a row, ids by Zipf
    popularity (a = 1.3) scattered by a multiplier, so the popular ids are
    in every row; "generator": the port's generator, whose rows repeat
    popular ids."""
    n, nnz, d = 256, 120, 60_013
    if rows == "generator":
        data = t_make(dim=d, num_instances=n, nnz_per_instance=nnz, seed=q)
    else:
        rng = np.random.default_rng(q)
        raw = np.minimum(rng.random((n, nnz)) ** (-1.0 / 0.3) - 1.0, d - nnz)
        ranks = np.sort(np.clip(np.floor(raw).astype(np.int64), 0, d - nnz - 1), axis=1)
        steps = np.arange(nnz)
        ranks = np.maximum.accumulate(ranks - steps, axis=1) + steps  # distinct in a row
        idx = ((ranks * 7919 + 12345) % d).astype(np.int32)
        val = rng.gamma(2.0, size=(n, nnz)).astype(np.float32)
        val /= np.linalg.norm(val, axis=1, keepdims=True)
        labels = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
        data = PaddedCSR(torch.from_numpy(idx), torch.from_numpy(val),
                         torch.from_numpy(labels), d)
    return BlockCSR.from_padded(data, t_balanced(d, q))


def _touch_step(bd: BlockCSR, u: int, seed: int, device="cpu"):
    """A step's gathered rows (as step_margins leaves them in ``out``), w,
    z and coefficients, on ``device``."""
    rng = np.random.default_rng(seed)
    bd = bd.to(device)
    ids = torch.from_numpy(rng.integers(0, bd.num_instances, size=u)).to(device)
    w = torch.from_numpy(rng.normal(size=bd.dim).astype(np.float32)).to(device)
    z = torch.from_numpy((rng.normal(size=bd.dim) * 0.1).astype(np.float32)).to(device)
    coef = torch.from_numpy(rng.normal(size=u).astype(np.float32)).to(device)
    rows = ops.step_rows(bd, u)
    ops.step_margins(bd, ids, w, out=rows)
    return bd, rows, w, z, coef


def _per_block_touch(bd, blocks, w, z, coef, reg):
    """q one-block touch updates, in place: the kernel's one-block launches
    on the card, the plain version on the CPU."""
    lam, lam1, lam2 = LAMS[reg]
    b = bd.partition.bounds
    for l, (idx, val) in enumerate(blocks):
        ops.lazy_block_touch_update(w[b[l]:b[l + 1]], idx, val, coef, z[b[l]:b[l + 1]],
                                    TOUCH_ETA, lam=lam, lam1=lam1, lam2=lam2)
    return w


@pytest.mark.parametrize("reg", list(LAMS))
@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("q", [1, 3, 8])
def test_step_touch_update_equals_per_block_plain_bitwise(q, u, reg):
    """On the CPU the step's touched pass is the per-block plain loop bit
    for bit, in place, with no launch; features no row touches keep their
    bits."""
    lam, lam1, lam2 = LAMS[reg]
    bd, rows, w, z, coef = _touch_step(_touch_layout("generator", q), u, seed=q + u)
    got, want = w.clone(), w.clone()
    before = ops.launch_counts()
    out = ops.lazy_step_touch_update(bd, rows, got, z, coef, TOUCH_ETA, lam=lam, lam1=lam1,
                                     lam2=lam2)
    assert out is got and ops.launch_counts() == before
    _per_block_touch(bd, rows.blocks, want, z, coef, reg)
    assert np.array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    b = bd.partition.bounds
    touched = torch.cat([idx.reshape(-1).long() + b[l]
                         for l, (idx, _) in enumerate(rows.blocks)]).unique()
    keep = torch.ones(bd.dim, dtype=torch.bool)
    keep[touched] = False
    assert torch.equal(got[keep], w[keep]) and not torch.equal(got, w)


def test_step_touch_update_refuses_unknown_devices_and_misfit_rows():
    bd, rows, w, z, coef = _touch_step(_touch_layout("generator", 3), 2, seed=0)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.lazy_step_touch_update(bd, rows, w.to("meta"), z, coef, 0.1, lam=0.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lazy_mod.touch_update(_build.BlockRows(), 3, rows.indices, rows.values, coef, w, z,
                              0.1, 0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# wrappers as far as the CPU can check them, and the card
# ---------------------------------------------------------------------------


def test_lazy_launchers_refuse_cpu_tensors():
    w, last, z, idx, val, coef, corr = _t(*_case(0, 1))
    calls = [
        lambda: lazy_mod.lazy_catchup(w, last, z, idx, 0.1, 1, 2, 0.0, 0.0, 0.0),
        lambda: lazy_mod.lazy_touch_update(w, idx, val, coef, z, 0.1, 0.0, 0.0, 0.0),
        lambda: lazy_mod.lazy_flush(w, last, z, 0.1, 2, 2, 0.0, 0.0, 0.0),
        lambda: lazy_mod.lazy_proba_update(w, idx, val, coef, z, corr, 0.1, 0.0, 0.0, 0.0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(a.copy()).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("u", [1, 8])
@pytest.mark.parametrize("reg", list(LAMS))
def test_lazy_kernels_match_plain_on_card(cuda_device, reg, u):
    """Catch-up, touch and flush are bitwise their plain versions (no
    atomics on either side of the replay; touch differs only where the
    plain index_add_ adds duplicates with atomics); proba within 1e-6."""
    lam, lam1, lam2 = LAMS[reg]
    w, last, z, idx, val, coef, corr = _case(u, u, nnz=161)
    for eta_m in (0.1, 0.0):
        a, b = _on(cuda_device, w, last), _on(cuda_device, w, last)
        zt, it = _on(cuda_device, z, idx)
        lazy_mod.lazy_catchup(*a, zt, it, 0.1, 7, 4 if eta_m == 0 else 8, lam, lam1, lam2)
        lazy_mod.lazy_catchup_plain(*b, zt, it, 0.1, 7, 4 if eta_m == 0 else 8, lam, lam1, lam2)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        lazy_mod.lazy_flush(*a, zt, 0.1, STEPS, 5, lam, lam1, lam2)
        lazy_mod.lazy_flush_plain(*b, zt, 0.1, STEPS, 5, lam, lam1, lam2)
        assert torch.equal(a[0], b[0])
        rows = _on(cuda_device, idx, val, coef)
        got = lazy_mod.lazy_touch_update(a[0], *rows, zt, eta_m, lam, lam1, lam2)
        want = lazy_mod.lazy_touch_update_plain(b[0], *rows, zt, eta_m, lam, lam1, lam2)
        assert bool(torch.all(torch.abs(got - want) <= 1e-7 + RTOL * torch.abs(want)))
        (ct,) = _on(cuda_device, corr)
        a, b = _on(cuda_device, w), _on(cuda_device, w)
        got = lazy_mod.lazy_proba_update(*a, *rows, zt, ct, eta_m, lam, lam1, lam2)
        want = lazy_mod.lazy_proba_update_plain(*b, *rows, zt, ct, eta_m, lam, lam1, lam2)
        assert bool(torch.all(torch.abs(got - want) <= 1e-6 + RTOL * torch.abs(want)))


def _bits_nan_aware(t: torch.Tensor) -> np.ndarray:
    """t's bits, NaN as one pattern (the card's and the CPU's NaNs differ)."""
    t = t.cpu()
    return torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t).numpy().view(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("reg", ["l2", "l1"])
@pytest.mark.parametrize("u", [1, 8, 64, 128])
@pytest.mark.parametrize("q", [1, 8, 16])
@pytest.mark.parametrize("rows", ["zipf", "generator"])
def test_step_touch_update_kernel_equals_cpu_plain_bitwise_on_card(cuda_device, rows, q, u,
                                                                     reg):
    """One launch over the q blocks equals q calls of the plain version on
    the CPU (whose index_add_ adds in flat order) bit for bit, twice, and q
    one-block launches.  "zipf" rows put the popular ids in every row;
    "generator" rows repeat ids within a row, the hard flat-order case."""
    lam, lam1, lam2 = LAMS[reg]
    bd, step_rows, w, z, coef = _touch_step(_touch_layout(rows, q), u, seed=u + q,
                                            device=cuda_device)
    cpu_blocks = [(idx.cpu(), val.cpu()) for idx, val in step_rows.blocks]
    want = _per_block_touch(bd.to("cpu"), cpu_blocks, w.cpu(), z.cpu(), coef.cpu(), reg)
    for _ in range(2):
        got = w.clone()
        before = ops.launch_counts()["lazy_touch_update"]
        ops.lazy_step_touch_update(bd, step_rows, got, z, coef, TOUCH_ETA, lam=lam, lam1=lam1,
                                   lam2=lam2)
        assert ops.launch_counts()["lazy_touch_update"] == before + 1
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))
    one_block = _per_block_touch(bd, step_rows.blocks, w.clone(), z, coef, reg)
    assert torch.equal(one_block.view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one id fills every entry", "padding only", "NaN coefficient"])
def test_step_touch_update_edge_cases_on_card(cuda_device, case):
    """Two blocks of u = 64 rows, the first made the edge case: one id in
    every entry (a chain of u * nnz adds), or padding only (id 0 updated
    with g = +0.0); or a NaN coefficient, which must reach every id of its
    row.  Bitwise the CPU's plain version, NaN taken as one pattern."""
    rng = np.random.default_rng(7)
    u, nnz, dims = 64, 40, (300, 500)
    idx = [rng.integers(0, d, size=(u, nnz)).astype(np.int32) for d in dims]
    val = [rng.normal(size=(u, nnz)).astype(np.float32) for _ in dims]
    coef = rng.normal(size=u).astype(np.float32)
    if case == "one id fills every entry":
        idx[0][:] = 17
    elif case == "padding only":
        idx[0][:], val[0][:] = 0, 0.0
    else:
        coef[3] = np.nan
    w = rng.normal(size=sum(dims)).astype(np.float32)
    z = (rng.normal(size=sum(dims)) * 0.1).astype(np.float32)
    lam, lam1, lam2 = LAMS["l2"]
    want, zt = _t(w, z)
    lo = 0
    for i, v, d in zip(idx, val, dims):
        lazy_mod.lazy_touch_update_plain(want[lo:lo + d], *_t(i, v, coef), zt[lo:lo + d],
                                         TOUCH_ETA, lam, lam1, lam2)
        lo += d
    dev = cuda_device
    it, vt = _on(dev, *idx), _on(dev, *val)
    rows = _build.block_rows("lazy_touch_update", it, vt, dims, it[0].device)
    got = torch.from_numpy(w).to(dev)
    lazy_mod.touch_update(rows, 2, torch.cat([i.reshape(-1) for i in it]),
                          torch.cat([v.reshape(-1) for v in vt]), torch.from_numpy(coef).to(dev),
                          got, torch.from_numpy(z).to(dev), TOUCH_ETA, lam, lam1, lam2)
    torch.cuda.synchronize()
    assert np.array_equal(_bits_nan_aware(got), _bits_nan_aware(want))
    if case == "NaN coefficient":
        assert int(torch.isnan(got).sum()) == sum(np.unique(i[3]).size for i in idx)
    elif case == "padding only":
        assert got[0].item() != w[0]  # id 0 moved by the dense step with g = +0.0


@pytest.mark.cuda
@pytest.mark.parametrize("reg", ["l2", "l1"])
@pytest.mark.parametrize("q", [1, 8, 16])
def test_exact_lazy_epoch_launches_one_touch_update_a_step_on_card(cuda_device, q, reg):
    """An exact-lazy epoch of M steps on the kernel route launches the
    touched pass M times, whatever q, and equals the dense epoch bit for
    bit on the card."""
    bd = _touch_layout("zipf", q).to(cuda_device)
    rng = np.random.default_rng(q)
    w0 = torch.from_numpy((rng.normal(size=bd.dim) * 0.01).astype(np.float32)).to(cuda_device)
    lam, lam2 = REGS[reg]
    t_reg = t_losses.Regularizer(reg, lam, lam2)
    z, s0 = t_fdsvrg._full_grad_blocks(bd, w0, t_losses.logistic, use_kernels=True)
    steps, u = 12, 32
    samples = rng.integers(0, bd.num_instances, size=(steps, u)).astype(np.int32)
    mask = np.ones(steps, dtype=np.float32)
    ops.reset_launch_counts()
    lazy = t_fdsvrg._lazy_inner_epoch(bd, w0, z, s0, samples, 0.25, mask, None,
                                      t_losses.logistic, t_reg, True, "exact")
    assert ops.launch_counts()["lazy_touch_update"] == steps
    dense = t_fdsvrg._inner_epoch(bd, w0, z, s0, samples, 0.25, mask, t_losses.logistic, t_reg,
                                  True)
    assert torch.equal(lazy, dense)


if __name__ == "__main__":
    # Worst error over the kernel cases, as a fraction of the stated
    # tolerance, and over the driver matrix (objective rel, w abs):
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lazy.py
    worst = {}
    for case in DRIVER_MATRIX:
        for key, val in _run_errors(*_fd_pair(*case)).items():
            worst[(case[0], key)] = max(val, worst.get((case[0], key), 0.0))
    print(worst)
    print({
        "lazy_catchup": max(_catchup_ratio(r, u, s) for r in LAMS for u in (1, 4)
                            for s in CATCHUP_STEPS),
        "lazy_touch_update": max(_touch_ratio(r, u, e) for r in LAMS for u in (1, 4)
                                 for e in (0.1, 0.0)),
        "lazy_flush": max(_flush_ratio(r, o) for r in LAMS for o in FLUSH_STEPS),
        "lazy_proba_update": max(_proba_ratio(r, u, e) for r in LAMS for u in (1, 4)
                                 for e in (0.1, 0.0)),
    })
