"""The port's front door (``repro_torch.api``) held against the
reference's (``repro.api``), on the CPU (``device="cpu"``).

The same generated bytes go through both packages (the synthetic
generators match byte for byte).  Exact: every meter field and the
history's ``comm_scalars`` / ``comm_rounds``, the resolved run of every
method and sentinel, the validation errors' types, the served versions,
skips, staleness and batches of the interleaved serve loop, and, within
the port, a one-vs-rest column against its binary fit (bitwise).  Stated
tolerances, as in ``tests/test_torch_fdsvrg.py``: objectives and grad
norms rtol 1e-5, ``w`` (and ``coef_``) atol 1e-5 (torch and XLA round
the margin sums and the sigmoid differently), scaled by ``max(1,
max|w|)`` for the one-vs-rest blobs, whose coefficients reach 6.7.

The ``cuda``-marked cases hold the kernel route through the front door
bitwise against the direct driver call and the margin kernel on the
card, and skip without one.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import api as r_api
from repro.api import registry as r_registry
from repro.configs.fdsvrg_linear import CONFIGS as R_CONFIGS
from repro.core import losses as r_losses
from repro.data.pipeline import ArraySource as RArraySource
from repro.data.sparse import PaddedCSR as RPaddedCSR
from repro.data.synthetic import make_sparse_classification as r_make
from repro.serve import batching as r_batching
from repro.serve import engine as r_engine
from repro.serve import loop as r_loop

from repro_torch import api as t_api
from repro_torch.api import registry as t_registry
from repro_torch.configs.fdsvrg_linear import CONFIGS as T_CONFIGS
from repro_torch.core import losses as t_losses
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.pipeline import ArraySource as TArraySource
from repro_torch.data.sparse import PaddedCSR as TPaddedCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.serve import batching as t_batching
from repro_torch.serve import engine as t_engine
from repro_torch.serve import loop as t_loop

RTOL = 1e-5
W_ATOL = 1e-5
MARGIN_RTOL = 1e-6
CPU = "cpu"
DATA = dict(dim=512, num_instances=48, nnz_per_instance=8, seed=2)
RUN = dict(q=2, eta=0.3, batch_size=2, inner_steps=8, outer_iters=2)
# Every method but the sharded one, whose worker count is the mesh's
# (tests/test_torch_shardmap.py holds it against the reference).
PORTED = sorted(m for m in r_api.METHODS if m != "fdsvrg_sharded")
# The methods whose kernel route the port has and the reference lacks.
KERNELS_ADDED = {"dsvrg", "synsvrg", "asysvrg", "pslite_sgd", "fd_saga", "fd_bcd",
                 "fdsvrg_sharded"}


@pytest.fixture(scope="module")
def pair():
    return r_make(**DATA), t_make(**DATA)


def _assert_close_runs(port, ref):
    """Meters and comm exact; objectives, grad norms and w within the
    stated tolerances."""
    assert port.meter.total_scalars == ref.meter.total_scalars
    assert port.meter.total_rounds == ref.meter.total_rounds
    for field in ("outer", "comm_scalars", "comm_rounds"):
        assert [getattr(h, field) for h in port.history] == \
            [getattr(h, field) for h in ref.history], field
    np.testing.assert_allclose([h.modeled_time_s for h in port.history],
                               [h.modeled_time_s for h in ref.history], rtol=1e-12)
    np.testing.assert_allclose(port.objectives(), ref.objectives(), rtol=RTOL)
    np.testing.assert_allclose([h.grad_norm for h in port.history],
                               [h.grad_norm for h in ref.history], rtol=RTOL)
    np.testing.assert_allclose(port.w.cpu().numpy(), np.asarray(ref.w), atol=W_ATOL, rtol=0)


_REF_RUNS: dict = {}


def _ref_solve(method, data):
    """The reference's run of ``method`` on the module's data (once)."""
    if method not in _REF_RUNS:
        _REF_RUNS[method] = r_api.solve(r_api.ExperimentSpec(
            method=method, data=data, reg=r_losses.l2(1e-3), **RUN))
    return _REF_RUNS[method]


# ---------------------------------------------------------------------------
# solve: every registered method against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain"])
@pytest.mark.parametrize("method", PORTED)
def test_solve_matches_reference(pair, method, use_kernels):
    r_data, t_data = pair
    port = t_api.solve(t_api.ExperimentSpec(
        method=method, data=t_data, reg=t_losses.l2(1e-3), device=CPU,
        use_kernels=use_kernels, **RUN))
    _assert_close_runs(port, _ref_solve(method, r_data))


def test_solve_is_the_direct_driver_call(pair):
    """The front door adds dispatch, never numerics: bitwise the direct
    call on the same layout."""
    from repro_torch.core.fdsvrg import SVRGConfig, run_fdsvrg
    from repro_torch.core.partition import balanced

    t_data = pair[1]
    reg = t_losses.l2(1e-3)
    cfg = SVRGConfig(eta=RUN["eta"], inner_steps=RUN["inner_steps"],
                     outer_iters=RUN["outer_iters"], batch_size=RUN["batch_size"])
    direct = run_fdsvrg(t_data, balanced(t_data.dim, 2), t_losses.logistic, reg, cfg,
                        device=CPU)
    via = t_api.solve(t_api.ExperimentSpec(method="fdsvrg", data=t_data, reg=reg,
                                           device=CPU, **RUN))
    assert torch.equal(via.w, direct.w)
    assert via.objectives().tolist() == direct.objectives().tolist()
    assert via.meter.total_scalars == direct.meter.total_scalars


# ---------------------------------------------------------------------------
# "paper" resolution, validation, the capability matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", sorted(r_api.METHODS))
def test_resolved_run_matches_reference(method):
    variants = [{}, {"eta": 0.7}, {"batch_size": 4}, {"inner_steps": 5},
                {"eta": 1.5, "batch_size": 3, "inner_steps": 11}]
    for n, q in ((100, 4), (48, 2), (10**6, 16), (3, 8)):
        for kw in variants:
            ref = r_registry._resolve(r_api.ExperimentSpec(method=method, dataset="news20", **kw),
                                      r_api.method_info(method), n, q)
            port = t_registry._resolve(
                t_api.ExperimentSpec(method=method, dataset="news20", **kw),
                t_api.method_info(method), n, q)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), (n, q, kw)


# (label, spec fields besides data, exception, match); both packages raise
# it for the same spec (the port's use_kernels set to the reference's).
VALIDATION = [
    ("option_ii_asysvrg", dict(method="asysvrg", option="II"), ValueError, "Option I/II"),
    ("option_ii_pslite", dict(method="pslite_sgd", option="II"), ValueError, "Option I/II"),
    ("option_ii_sharded", dict(method="fdsvrg_sharded", option="II"), ValueError,
     "Option I/II"),
    ("tree_mode", dict(method="dsvrg", tree_mode="butterfly"), ValueError, "tree_mode"),
    ("mesh_q_mismatch", dict(method="fdsvrg_sharded", q=8), ValueError, "mesh"),
    ("unknown_method", dict(method="sgd"), ValueError, "registered methods"),
    ("lazy_on_baseline", dict(method="dsvrg", lazy_updates="exact"), ValueError,
     "lazy_updates"),
    ("checkpoint_on_saga", dict(method="fd_saga", checkpoint_dir="ck"), ValueError,
     "checkpoint"),
    ("no_data", dict(method="serial", data=None), ValueError, "exactly one"),
    ("two_data", dict(method="serial", dataset="news20"), ValueError, "exactly one"),
    ("reg_float", dict(method="serial", reg=1e-4), TypeError, "ONE regularizer"),
    ("option_iii", dict(method="serial", option="III"), ValueError, "option"),
    ("eta_auto", dict(method="serial", eta="auto"), ValueError, "eta"),
    ("batch_zero", dict(method="serial", batch_size=0), ValueError, "batch_size"),
    ("inner_zero", dict(method="serial", inner_steps=0), ValueError, "inner_steps"),
    ("outer_zero", dict(method="serial", outer_iters=0), ValueError, "outer_iters"),
    ("eta_zero", dict(method="serial", eta=0.0), ValueError, "eta"),
    ("resume_no_dir", dict(method="serial", resume=True), ValueError, "checkpoint_dir"),
]


@pytest.mark.parametrize("fields,exc,match", [v[1:] for v in VALIDATION],
                         ids=[v[0] for v in VALIDATION])
def test_validation_matches_reference(pair, fields, exc, match):
    r_data, t_data = pair
    for api, data, extra in ((r_api, r_data, {}),
                             (t_api, t_data, {"device": CPU, "use_kernels": False})):
        kw = {"data": data, **extra, **fields}
        with pytest.raises(exc, match=match):
            api.solve(api.ExperimentSpec(**kw))


def test_port_refusals(pair):
    """What the port refuses where the reference runs: a mesh that is not
    a ``DeviceMesh``, float64 on the kernel route; and no device is chosen
    behind the caller's back.  The sharded driver runs without a mesh (one
    rank), bitwise the one-block ``fdsvrg`` run."""
    t_data = pair[1]
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_api.ExperimentSpec(method="fdsvrg_sharded", data=t_data, mesh=object())
    one = dict(RUN, q=None)
    sharded = t_api.solve(t_api.ExperimentSpec(method="fdsvrg_sharded", data=t_data,
                                               use_kernels=False, device=CPU, **one))
    direct = t_api.solve(t_api.ExperimentSpec(method="fdsvrg", data=t_data,
                                              use_kernels=False, device=CPU, **dict(one, q=1)))
    assert torch.equal(sharded.w, direct.w)
    assert sharded.objectives().tolist() == direct.objectives().tolist()
    wide = dataclasses.replace(t_data, values=t_data.values.double(),
                               labels=t_data.labels.double())
    with pytest.raises(ValueError, match="float32"):
        t_api.ExperimentSpec(method="fdsvrg", data=wide, device=CPU)
    res = t_api.solve(t_api.ExperimentSpec(method="fdsvrg", data=wide, device=CPU,
                                           use_kernels=False, **RUN))
    assert res.w.dtype == torch.float64 and np.isfinite(res.final_objective())
    spec = t_api.ExperimentSpec(method="fdsvrg", data=t_data, **RUN)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_api.solve(spec)


def test_capability_matrix_pinned():
    """The port's matrix is the reference's but for ``kernels`` on the
    seven methods the port has a kernel route for, and two summaries that
    name JAX mechanisms."""
    ref = {r["method"]: r for r in r_api.capability_matrix()}
    port = {r["method"]: r for r in t_api.capability_matrix()}
    assert list(port) == list(ref)
    diffs = {(m, k) for m in ref for k in ref[m] if port[m][k] != ref[m][k]}
    assert diffs == {(m, "kernels") for m in KERNELS_ADDED} | {
        ("fdsvrg", "summary"), ("fdsvrg_sharded", "summary")}
    assert {m for m, r in port.items() if r["kernels"]} == set(r_api.METHODS)


def test_sharded_kernel_route_runs_where_the_reference_refuses(pair):
    """``fdsvrg_sharded`` with ``use_kernels=True``: the reference refuses
    it (its kernel path is not certified through solve); the port runs it,
    bitwise the one-block ``fdsvrg`` kernel-route run (on the CPU the
    kernels' plain versions)."""
    r_data, t_data = pair
    one = dict(RUN, q=None)
    with pytest.raises(ValueError, match="use_kernels"):
        r_api.solve(r_api.ExperimentSpec(method="fdsvrg_sharded", data=r_data,
                                         use_kernels=True, **one))
    sharded = t_api.solve(t_api.ExperimentSpec(method="fdsvrg_sharded", data=t_data,
                                               device=CPU, tree_mode="butterfly", **one))
    direct = t_api.solve(t_api.ExperimentSpec(method="fdsvrg", data=t_data, device=CPU,
                                              **dict(one, q=1)))
    assert torch.equal(sharded.w, direct.w)
    assert sharded.objectives().tolist() == direct.objectives().tolist()
    assert sharded.meter.total_scalars == direct.meter.total_scalars == 0


# ---------------------------------------------------------------------------
# the BlockCSR cache
# ---------------------------------------------------------------------------


def test_block_cache_bounded_per_sweep_and_per_device():
    kw = dict(dim=64, num_instances=8, nnz_per_instance=4)
    a, b = t_make(seed=0, **kw), t_make(seed=1, **kw)
    cache = t_api.BlockCache(max_entries=4)
    blk = cache.get(a, 2, CPU)
    assert cache.get(a, 2, torch.device(CPU)) is blk  # hit
    meta = cache.get(a, 2, "meta")  # same data and q on another device
    assert meta is not blk and meta.device.type == "meta"
    assert cache.get(a, 2, CPU) is blk and len(cache) == 2
    cache.get(b, 2, CPU)
    assert all(obj is b for obj, _ in cache.values())  # a's entries evicted
    for q in (1, 2, 4, 8, 16, 32):
        cache.get(b, q, CPU)
    assert len(cache) <= cache.max_entries


def test_block_csr_to_its_own_device_is_itself(pair):
    t_data = pair[1]
    t_api.BLOCK_CACHE.clear()
    bd = t_api.BLOCK_CACHE.get(t_data, 2, CPU)
    assert bd.to(bd.device) is bd and bd.to("cpu") is bd
    assert bd.to("meta") is not bd
    # a run on the cached layout keeps its row tables (the card's
    # block_rows lives in the same per-device dict)
    marker = object()
    bd._block_rows["cpu"] = marker
    spec = t_api.ExperimentSpec(method="fdsvrg", data=t_data, device=CPU, **RUN)
    t_api.solve(spec)
    t_api.solve(spec.replace(method="fdsvrg_sim"))
    assert t_api.BLOCK_CACHE.get(t_data, 2, CPU) is bd
    assert bd._block_rows == {"cpu": marker}
    t_api.BLOCK_CACHE.clear()


def test_solve_hits_the_cache_across_replace_and_dataset_names(pair):
    t_data = pair[1]
    t_api.BLOCK_CACHE.clear()
    spec = t_api.ExperimentSpec(method="fdsvrg", data=t_data, device=CPU, **RUN)
    t_api.solve(spec)
    blk = t_api.BLOCK_CACHE.get(t_data, 2, CPU)
    t_api.solve(spec.replace(reg=t_losses.l1(1e-4)))
    t_api.solve(spec.replace(method="fd_saga", option="I"))
    assert t_api.BLOCK_CACHE.get(t_data, 2, CPU) is blk and len(t_api.BLOCK_CACHE) == 1
    assert t_registry._load_dataset("news20") is t_registry._load_dataset("news20")
    t_api.BLOCK_CACHE.clear()


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

EST = dict(method="fdsvrg", workers=2, eta=0.3, lam=1e-3, batch_size=2, inner_steps=16,
           outer_iters=3)


def _close_history(port, ref):
    for field in ("outer", "comm_scalars", "comm_rounds"):
        assert [getattr(h, field) for h in port] == [getattr(h, field) for h in ref], field
    np.testing.assert_allclose([h.objective for h in port], [h.objective for h in ref],
                               rtol=RTOL)


def test_estimator_fit_predict_score_matches_reference(pair):
    r_data, t_data = pair
    ref = r_api.FDSVRGClassifier(**EST).fit(r_data)
    port = t_api.FDSVRGClassifier(device=CPU, **EST).fit(t_data)
    assert port.n_features_in_ == ref.n_features_in_ == t_data.dim
    assert port.coef_.shape == (t_data.dim,) and isinstance(port.coef_, np.ndarray)
    np.testing.assert_allclose(port.coef_, ref.coef_, atol=W_ATOL, rtol=0)
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    _close_history(port.history_, ref.history_)
    rm, pm = ref.decision_function(r_data), port.decision_function(t_data)
    assert pm.shape == (t_data.num_instances,)
    np.testing.assert_allclose(pm, rm, atol=2 * W_ATOL * DATA["nnz_per_instance"], rtol=0)
    sure = np.abs(rm) > 1e-3
    np.testing.assert_array_equal(port.predict(t_data)[sure], ref.predict(r_data)[sure])
    assert port.score(t_data) == pytest.approx(ref.score(r_data), abs=1 / 48)
    assert port.score(t_data) > 0.7
    # the margins are the serving tier's, bit for bit
    engine = t_engine.PredictionEngine.from_estimator(port, use_kernels=False)
    assert engine.margins(t_data.indices.numpy(), t_data.values.numpy()).tobytes() == \
        pm.tobytes()


@pytest.mark.parametrize("method", ["serial", "fdsvrg"])
def test_estimator_partial_fit_rebases_history_like_reference(pair, method):
    r_data, t_data = pair
    kw = dict(EST, method=method, outer_iters=2)
    ref = r_api.FDSVRGClassifier(**kw).fit(r_data).partial_fit(r_data, outer_iters=2)
    port = t_api.FDSVRGClassifier(device=CPU, **kw).fit(t_data)
    first = port.history_[0].objective
    port.partial_fit(t_data, outer_iters=2)
    assert [h.outer for h in port.history_] == [0, 1, 2, 3]
    assert port._fits == 2  # the second solve ran at seed + 1
    _close_history(port.history_, ref.history_)
    np.testing.assert_allclose(port.coef_, ref.coef_, atol=W_ATOL, rtol=0)
    assert port.history_[2].objective < first
    for prev, cur in zip(port.history_, port.history_[1:]):
        assert cur.comm_scalars >= prev.comm_scalars
        assert cur.modeled_time_s >= prev.modeled_time_s
        assert cur.wall_time_s >= prev.wall_time_s
    assert port.free_training_cache() is port and port._encoded is None
    assert port.score(t_data) >= 0.0


def test_estimator_reuses_encoded_data_and_decodes_labels(pair):
    kw = dict(dim=64, num_instances=16, nnz_per_instance=4, seed=3)
    raw = t_make(**kw)
    y01 = (raw.labels.numpy() > 0).astype(int)  # {0, 1}: forces a re-encode
    clf = t_api.FDSVRGClassifier(device=CPU, **dict(EST, inner_steps=4, outer_iters=1))
    clf.fit(raw, y01)
    encoded = clf._encoded[2]
    assert set(np.unique(encoded.labels.numpy())) == {-1.0, 1.0}
    clf.partial_fit(raw, y01)
    assert clf._encoded[2] is encoded
    assert encoded.labels.dtype == raw.values.dtype
    assert clf.score(raw) == clf.score(raw, y01)
    # ±1 labels already in place: the data object itself is trained on
    t_data = pair[1]
    clf.fit(t_data)
    assert clf._encoded[2] is t_data


def test_estimator_string_labels_dense_input_matches_reference():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(20, 8))
    y = np.where(rng.random(20) < 0.5, "ham", "spam")
    y[:2] = ["ham", "spam"]
    kw = dict(method="serial", eta=0.5, lam=1e-3, inner_steps=20, outer_iters=2)
    ref = r_api.FDSVRGClassifier(**kw).fit(X, y)
    port = t_api.FDSVRGClassifier(device=CPU, **kw).fit(X, y)
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    assert port.coef_.dtype == np.float32
    np.testing.assert_allclose(port.coef_, ref.coef_, atol=W_ATOL, rtol=0)
    _close_history(port.history_, ref.history_)
    assert set(np.unique(port.predict(X))) <= {"ham", "spam"}
    assert port.score(X, y) == ref.score(X, y)


def _three_blobs(seed=0, per_class=30, dim=8):
    rng = np.random.default_rng(seed)
    centers = np.eye(3, dim) * 6.0
    X = np.concatenate([rng.normal(size=(per_class, dim)) + centers[c] for c in range(3)])
    return X, np.repeat(np.arange(3), per_class)


@pytest.mark.parametrize("method", ["serial", "fdsvrg"])
def test_one_vs_rest_columns_are_binary_fits(method):
    """OvR column j is bitwise the port's binary fit of (class j vs rest)
    on the kernel route (k scalar kernel-path epochs over one stream), and
    within the stated tolerances of the reference's column; a warm start
    takes the [d, k] coef_.T."""
    X, y_int = _three_blobs(seed=3)
    y = np.array(["ant", "bee", "cat"])[y_int]
    kw = dict(method=method, eta=0.5, lam=1e-4, inner_steps=32, outer_iters=3,
              batch_size=1, workers=2)
    multi = t_api.FDSVRGClassifier(device=CPU, **kw).fit(X, y)
    ref = r_api.FDSVRGClassifier(**kw).fit(X, y)
    assert multi.coef_.shape == ref.coef_.shape == (3, X.shape[1])
    np.testing.assert_array_equal(multi.classes_, ref.classes_)
    w_atol = W_ATOL * max(1.0, float(np.max(np.abs(ref.coef_))))
    np.testing.assert_allclose(multi.coef_, ref.coef_, atol=w_atol, rtol=0)
    _close_history(multi.history_, ref.history_)
    binaries = [t_api.FDSVRGClassifier(device=CPU, **kw).fit(X, (y == cls).astype(int))
                for cls in multi.classes_]
    for j, binary in enumerate(binaries):
        assert multi.coef_[j].tobytes() == binary.coef_.tobytes()
    assert multi.decision_function(X).shape == (X.shape[0], 3)
    assert multi.score(X, y) > 0.9 and multi.score(X, y) == ref.score(X, y)
    # the warm start: each column is still its binary run, warm-started
    # alike (against the reference only the meters: at eta = 0.5 on these
    # unscaled blobs the two frameworks' last-bit differences grow past
    # the tolerances within five outers)
    first = multi.history_[0].objective
    multi.partial_fit(X, y, outer_iters=2)
    ref.partial_fit(X, y, outer_iters=2)
    for j, binary in enumerate(binaries):
        binary.partial_fit(X, (y == multi.classes_[j]).astype(int), outer_iters=2)
        assert multi.coef_[j].tobytes() == binary.coef_.tobytes()
    for field in ("outer", "comm_scalars", "comm_rounds"):
        assert [getattr(h, field) for h in multi.history_] == \
            [getattr(h, field) for h in ref.history_], field
    assert multi.history_[3].objective < first


def test_as_padded_csr_round_trips_like_reference():
    X = np.array([[0.0, 1.5, 0.0, -2.0], [3.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    y = np.array([1.0, -1.0, 1.0])
    rng = np.random.default_rng(7)
    Xr = rng.normal(size=(37, 23)).astype(np.float32)
    Xr[rng.random(Xr.shape) < 0.8] = 0.0
    yr = np.where(rng.random(37) < 0.5, 1.0, -1.0)
    for dense, labels in ((X, y), (Xr, yr)):
        port = t_api.as_padded_csr(dense, labels)
        ref = r_api.as_padded_csr(dense, labels)
        assert isinstance(port, TPaddedCSR) and port.values.dtype == torch.float32
        assert (port.dim, port.num_instances) == (dense.shape[1], dense.shape[0])
        np.testing.assert_array_equal(port.to_dense().T, dense.astype(np.float32))
        assert port.indices.numpy().tobytes() == np.asarray(ref.indices).tobytes()
        assert port.values.numpy().tobytes() == np.asarray(ref.values).tobytes()
        assert t_api.as_padded_csr(port) is port
    with pytest.raises(ValueError, match="labels but X holds"):
        t_api.as_padded_csr(np.ones((3, 2)), np.array([1.0, -1.0]))
    with pytest.raises(ValueError, match="labels but the PaddedCSR"):
        t_api.as_padded_csr(port, np.ones(3))


def test_estimator_refusals():
    with pytest.raises(ValueError, match="not fitted"):
        t_api.FDSVRGClassifier(device=CPU).predict(np.zeros((2, 3)))
    with pytest.raises(ValueError, match="at least 2 classes"):
        t_api.FDSVRGClassifier(method="serial", device=CPU).fit(np.ones((4, 3)), np.zeros(4))
    with pytest.raises(ValueError, match="not fitted"):
        t_engine.WeightSnapshot.from_estimator(t_api.FDSVRGClassifier(device=CPU), 0)


# ---------------------------------------------------------------------------
# the interleaved serve loop (tests/test_serve_engine.py:318-419)
# ---------------------------------------------------------------------------

STREAM = dict(dim=256, num_requests=300, nnz_lo=2, nnz_hi=16, seed=0)
WARM = dict(method="serial", eta=0.3, lam=1e-3, inner_steps=8, outer_iters=1)


class Clock:
    """A scripted clock: each read advances it by ``step`` seconds."""

    def __init__(self, step=0.0005):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _sorted_by_label(rows, padded_csr, tensor):
    order = np.argsort(np.asarray(rows.labels), kind="stable")
    return padded_csr(indices=tensor(np.asarray(rows.indices)[order]),
                      values=tensor(np.asarray(rows.values)[order]),
                      labels=tensor(np.asarray(rows.labels)[order]), dim=rows.dim)


def _interleaved(api, loop, engine_mod, batching, src, rows, clf_kw):
    """Warm up on the stream's first 128 rows, then serve ``src`` with an
    update every 2 chunks of 50, recording each published version."""
    warm = type(rows)(indices=rows.indices[:128], values=rows.values[:128],
                      labels=rows.labels[:128], dim=rows.dim)
    clf = api.FDSVRGClassifier(**WARM, **clf_kw).fit(warm)
    engine = engine_mod.PredictionEngine.from_estimator(clf, use_kernels=False)
    published = {0: np.asarray(engine.snapshot.w).copy()}
    orig = engine.publish

    def recording_publish(snap):
        published[snap.version] = np.array(snap.w)
        return orig(snap)

    engine.publish = recording_publish
    batcher = batching.MicroBatcher(max_batch=32, max_delay_s=0.0, min_width=4, clock=Clock())
    report = loop.run_serve_loop(src, engine, batcher, classifier=clf, update_every_chunks=2,
                                 chunk_rows=50, clock=Clock())
    return report, published


@pytest.mark.parametrize("order", ["stream", "sorted_by_label"])
def test_interleaved_serve_loop_matches_reference(order):
    r_src = r_loop.synthetic_request_source(**STREAM)
    t_src = t_loop.synthetic_request_source(**STREAM)
    r_warm, t_warm = r_src.materialize(), t_src.materialize()
    r_rows, t_rows = r_warm, t_warm
    if order == "sorted_by_label":  # chunks of one class: the updates skip them
        import jax.numpy as jnp

        r_rows = _sorted_by_label(r_rows, RPaddedCSR, jnp.asarray)
        t_rows = _sorted_by_label(t_rows, TPaddedCSR, torch.from_numpy)
        r_src, t_src = RArraySource(r_rows), TArraySource(t_rows)
    ref, r_pub = _interleaved(r_api, r_loop, r_engine, r_batching, r_src, r_warm, {})
    port, t_pub = _interleaved(t_api, t_loop, t_engine, t_batching, t_src, t_warm,
                               {"device": CPU})
    for field in ("num_requests", "num_batches", "versions_published", "updates_skipped",
                  "bucket_counts", "flush_causes", "compiled_shapes"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.versions_published + port.updates_skipped == 3  # chunks 2, 4, 6
    if order == "sorted_by_label":
        assert port.updates_skipped > 0
    else:
        assert port.updates_skipped == 0
        assert set(port.staleness_histogram()) == {0, 1}
    assert port.staleness_histogram() == ref.staleness_histogram()
    assert [(r.req_id, r.version_used, r.staleness) for r in port.served] == \
        [(r.req_id, r.version_used, r.staleness) for r in ref.served]
    assert [r.latency_s for r in port.served] == [r.latency_s for r in ref.served]
    assert sorted(t_pub) == sorted(r_pub) == list(range(port.versions_published + 1))
    for v in t_pub:
        np.testing.assert_allclose(t_pub[v], r_pub[v], atol=W_ATOL, rtol=0)
    assert not np.array_equal(t_pub[0], t_pub[max(t_pub)])
    # every served margin is bitwise the row scored alone, at its bucket
    # width, against the version it reports
    idx, val = t_rows.indices.numpy(), t_rows.values.numpy()
    for r in port.served:
        keep = val[r.req_id] != 0.0
        ri, rv = idx[r.req_id, keep], val[r.req_id, keep]
        width = t_batching.bucket_width(len(ri), min_width=4)
        pi, pv = np.zeros((1, width), np.int32), np.zeros((1, width), np.float32)
        pi[0, :len(ri)], pv[0, :len(rv)] = ri, rv
        want = t_engine.batched_margins(pi, pv, t_pub[r.version_used], use_kernels=False,
                                        device=CPU)
        assert np.asarray(r.margin).tobytes() == want[0].tobytes()


def test_serve_loop_guards_like_reference():
    t_src = t_loop.synthetic_request_source(**STREAM)
    engine = t_engine.PredictionEngine(
        t_engine.WeightSnapshot.from_dense(np.ones(STREAM["dim"], np.float32), 0, device=CPU))
    with pytest.raises(ValueError, match="fitted"):
        t_loop.run_serve_loop(t_src, engine, t_batching.MicroBatcher(),
                              classifier=t_api.FDSVRGClassifier(device=CPU))


# ---------------------------------------------------------------------------
# LinearConfig.to_spec and the CLI
# ---------------------------------------------------------------------------


def test_linear_config_to_spec_matches_reference():
    for name, r_cfg in R_CONFIGS.items():
        ref, port = r_cfg.to_spec(), T_CONFIGS[name].to_spec(device=CPU)
        for field in ("method", "dataset", "q", "eta", "batch_size", "outer_iters", "loss",
                      "inner_steps"):
            assert getattr(port, field) == getattr(ref, field), (name, field)
        assert (port.reg.name, port.reg.lam, port.reg.lam2) == \
            (ref.reg.name, ref.reg.lam, ref.reg.lam2)
        assert port.use_kernels and str(port.device) == CPU
    spec = T_CONFIGS["fdsvrg-news20"].to_spec(method="dsvrg", outer_iters=2, inner_steps=5)
    assert (spec.method, spec.outer_iters, spec.inner_steps) == ("dsvrg", 2, 5)


def test_cli_list_and_refusals(capsys):
    from repro_torch.api import cli

    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in r_api.METHODS:
        assert name in out
    assert "multi_output" in out and "kernels" in out
    assert cli.main([]) == 2
    capsys.readouterr()
    # The sharded method runs in one process as one rank, and says so.
    assert cli.main(["--config", "fdsvrg-news20", "--method", "fdsvrg_sharded",
                     "--use-kernels", "--outer-iters", "1", "--inner-steps", "20",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "q=1 rank in this process" in out and "final objective" in out
    assert cli.main(["--config", "fdsvrg-news20", "--method", "sgd", "--device", "cpu"]) == 2
    assert cli.main(["--config", "fdsvrg-news20", "--method", "fdsvrg_sharded",
                     "--workers", "8", "--quick", "--device", "cpu"]) == 2
    assert "mesh" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli.main(["--config", "fdsvrg-news20", "--quick"]) == 2
        assert "CUDA" in capsys.readouterr().err


def test_cli_quick_run_matches_solve(capsys):
    """``--quick`` on scaled news20 (q = 8, 2 outers, 300 inner steps)
    prints the run ``solve`` gives for the same spec."""
    from repro_torch.api import cli

    assert cli.main(["--config", "fdsvrg-news20", "--quick", "--device", "cpu",
                     "--no-use-kernels"]) == 0
    out = capsys.readouterr().out
    res = t_api.solve(T_CONFIGS["fdsvrg-news20"].to_spec(
        outer_iters=2, inner_steps=300, device=CPU, use_kernels=False))
    assert "objective" in out and "comm scalars" in out
    for h in res.history:
        assert f"{h.objective:>12.6f} {h.grad_norm:>12.4e} {h.comm_scalars:>13,}" in out
    assert f"final objective {res.final_objective():.6f}" in out


def test_cli_module_entry_point():
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.api.cli", "--list"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0 and "fd_bcd" in out.stdout


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_solve_kernel_route_on_card_is_the_direct_run(cuda_device, pair):
    from repro_torch.core.fdsvrg import SVRGConfig, run_fdsvrg
    from repro_torch.core.partition import balanced
    from repro_torch.kernels import ops

    t_data = pair[1]
    reg = t_losses.l2(1e-3)
    cfg = SVRGConfig(eta=RUN["eta"], inner_steps=RUN["inner_steps"],
                     outer_iters=RUN["outer_iters"], batch_size=RUN["batch_size"])
    bd = BlockCSR.from_padded(t_data, balanced(t_data.dim, 2)).to(cuda_device)
    direct = run_fdsvrg(None, bd.partition, t_losses.logistic, reg, cfg, block_data=bd)
    t_api.BLOCK_CACHE.clear()
    spec = t_api.ExperimentSpec(method="fdsvrg", data=t_data, reg=reg, **RUN)
    ops.reset_launch_counts()
    via = t_api.solve(spec)
    assert ops.launch_counts()["sparse_margin"] > 0
    assert torch.equal(via.w, direct.w)
    assert via.objectives().tolist() == direct.objectives().tolist()
    cached = t_api.BLOCK_CACHE.get(t_data, 2, cuda_device)
    rows = dict(cached._block_rows)
    assert rows  # built by the first run, on the cached layout itself
    again = t_api.solve(spec)
    assert t_api.BLOCK_CACHE.get(t_data, 2, cuda_device) is cached
    assert all(cached._block_rows[k] is v for k, v in rows.items())
    assert torch.equal(again.w, via.w)
    t_api.BLOCK_CACHE.clear()


@pytest.mark.cuda
def test_estimator_margins_on_card_are_the_kernel(cuda_device, pair):
    from repro_torch.kernels import ops

    t_data = pair[1]
    clf = t_api.FDSVRGClassifier(**EST).fit(t_data)
    got = clf.decision_function(t_data)
    want = ops.sparse_margins(t_data.indices.to(cuda_device), t_data.values.to(cuda_device),
                              torch.from_numpy(clf.coef_).to(cuda_device))
    assert got.tobytes() == want.cpu().numpy().tobytes()
    cpu = t_api.FDSVRGClassifier(device=CPU, **EST).fit(t_data)
    np.testing.assert_allclose(clf.coef_, cpu.coef_, atol=W_ATOL, rtol=0)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
