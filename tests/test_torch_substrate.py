"""The PyTorch port's substrate held against the JAX reference, on the CPU.

Same inputs (numpy, from a seed) go through each ``repro`` module and its
``repro_torch`` counterpart.  Exact where the reference's bytes are
reachable (generator, BlockCSR layout, schedules, closed forms, meters,
sample stream, ``local_scatter``); stated tolerances elsewhere:

* losses and regularizers: rtol 1e-6 (``torch.sigmoid``/``logaddexp``
  are not bit-identical to jax's);
* margins: ``|d| <= 1e-6 * sum_k |w[idx] * val|`` per row (another
  summation order).
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fdsvrg_linear as r_configs
from repro.core import driver as r_driver
from repro.core import losses as r_losses
from repro.core import partition as r_partition
from repro.data import datasets as r_datasets
from repro.data import sparse as r_sparse
from repro.data.block_csr import BlockCSR as RBlockCSR
from repro.data.block_csr import local_margins as r_local_margins
from repro.data.block_csr import local_scatter as r_local_scatter
from repro.data.synthetic import make_sparse_classification as r_make
from repro.dist import collectives as r_coll
from repro.dist import costs as r_costs
from repro.dist import meter as r_meter
from repro.dist import metering as r_metering
from repro.dist import shardmap as r_shardmap
from repro.dist import tree as r_tree

from repro_torch import convert
from repro_torch.configs import fdsvrg_linear as t_configs
from repro_torch.core import driver as t_driver
from repro_torch.core import losses as t_losses
from repro_torch.core import partition as t_partition
from repro_torch.core.fdsvrg import SVRGConfig, run_fdsvrg, run_serial_svrg
from repro_torch.data import datasets as t_datasets
from repro_torch.data import sparse as t_sparse
from repro_torch.data.block_csr import BlockCSR as TBlockCSR
from repro_torch.data.block_csr import local_margins as t_local_margins
from repro_torch.data.block_csr import local_scatter as t_local_scatter
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.dist import collectives as t_coll
from repro_torch.dist import costs as t_costs
from repro_torch.dist import meter as t_meter
from repro_torch.dist import metering as t_metering
from repro_torch.dist import shardmap as t_shardmap
from repro_torch.dist import tree as t_tree
from repro_torch.dist.faults import FaultError

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-6
MARGIN_RTOL = 1e-6


def _pair(dim=4096, n=256, nnz=16, seed=0):
    kw = dict(dim=dim, num_instances=n, nnz_per_instance=nnz, seed=seed)
    return r_make(**kw), t_make(**kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# data: generator, presets, configs, partitions, BlockCSR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dim,n,nnz,seed", [(4096, 256, 16, 0), (517, 41, 11, 3), (67_760, 64, 64, 7)]
)
def test_synthetic_bytes_match_reference(dim, n, nnz, seed):
    r, t = _pair(dim, n, nnz, seed)
    for name in ("indices", "values", "labels"):
        a, b = np.asarray(getattr(r, name)), _np(getattr(t, name))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
    assert r.dim == t.dim and r.nnz_max == t.nnz_max
    assert r.nnz_total() == t.nnz_total()


def test_dataset_presets_match_reference():
    for table in ("TABLE1_FULL", "TABLE1_SCALED"):
        r_tab, t_tab = getattr(r_datasets, table), getattr(t_datasets, table)
        assert r_tab.keys() == t_tab.keys()
        for key in r_tab:
            assert dataclasses.astuple(r_tab[key]) == dataclasses.astuple(t_tab[key])
            assert r_datasets.materialize_bytes(r_tab[key]) == \
                t_datasets.materialize_bytes(t_tab[key])
    r, t = r_datasets.load("news20"), t_datasets.load("news20")
    assert np.asarray(r.indices).tobytes() == t.indices.numpy().tobytes()
    assert np.asarray(r.values).tobytes() == t.values.numpy().tobytes()


def test_dataset_memory_guard_raises():
    with pytest.raises(MemoryError, match="url"):
        t_datasets.load("url", scaled=False)
    with pytest.raises(MemoryError):
        t_datasets.load("news20", max_bytes=1)


def test_linear_configs_match_reference():
    assert r_configs.CONFIGS.keys() == t_configs.CONFIGS.keys()
    for key, r_cfg in r_configs.CONFIGS.items():
        t_cfg = t_configs.CONFIGS[key]
        assert dataclasses.astuple(r_cfg) == dataclasses.astuple(t_cfg)
        r_reg, t_reg = r_cfg.regularizer(), t_cfg.regularizer()
        assert (r_reg.name, r_reg.lam, r_reg.lam2) == (t_reg.name, t_reg.lam, t_reg.lam2)
    with pytest.raises(ValueError, match="available configs"):
        t_configs.get_config("fdsvrg-nope")


@pytest.mark.parametrize("q", [1, 2, 3, 8, 16])
def test_partitions_match_reference(q):
    r, t = _pair(517, 41, 11, 1)
    a, b = r_partition.balanced(517, q), t_partition.balanced(517, q)
    assert (a.dim, a.bounds, a.block_sizes()) == (b.dim, b.bounds, b.block_sizes())
    assert [a.owner_of(f) for f in (0, 100, 516)] == [b.owner_of(f) for f in (0, 100, 516)]
    counts_r = r_partition.feature_counts(np.asarray(r.indices), np.asarray(r.values), 517)
    counts_t = t_partition.feature_counts(t.indices.numpy(), t.values.numpy(), 517)
    np.testing.assert_array_equal(counts_r, counts_t)
    assert r_partition.by_nnz(517, q, counts_r).bounds == \
        t_partition.by_nnz(517, q, counts_t).bounds


def _assert_block_csr_equal(r_bd, t_bd):
    assert r_bd.nnz_budgets == t_bd.nnz_budgets
    assert r_bd.block_dims == t_bd.block_dims
    assert r_bd.partition.bounds == t_bd.partition.bounds
    assert r_bd.global_nnz_max() == t_bd.global_nnz_max()
    for l in range(r_bd.num_blocks):
        for a, b in (
            (r_bd.indices[l], t_bd.indices[l]),
            (r_bd.values[l], t_bd.values[l]),
            (r_bd.nnz_col_block(l), t_bd.nnz_col_block(l)),
        ):
            a, b = np.asarray(a), _np(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert np.asarray(r_bd.labels).tobytes() == t_bd.labels.numpy().tobytes()


@pytest.mark.parametrize("q,lane", [(1, 1), (2, 1), (4, 1), (8, 1), (8, 8), (5, 4)])
def test_block_csr_from_padded_matches_reference(q, lane):
    r, t = _pair()
    r_bd = RBlockCSR.from_padded(r, r_partition.balanced(r.dim, q), lane_multiple=lane)
    t_bd = TBlockCSR.from_padded(t, t_partition.balanced(t.dim, q), lane_multiple=lane)
    _assert_block_csr_equal(r_bd, t_bd)


def test_block_csr_drops_explicit_zeros_like_reference():
    """Explicit zeros (incl. a genuine (lo, 0.0) entry) become padding."""
    r, _ = _pair(64, 12, 6, 2)
    idx = np.asarray(r.indices).copy()
    val = np.asarray(r.values).copy()
    val[::3, 1] = 0.0
    idx[0, 0], val[0, 0] = 32, 0.0  # lands on block 1's padding pattern
    r_data = r_sparse.PaddedCSR(jnp.asarray(idx), jnp.asarray(val), r.labels, 64)
    t_data = convert.padded_csr(idx, val, np.asarray(r.labels), 64)
    r_bd = RBlockCSR.from_padded(r_data, r_partition.balanced(64, 2))
    t_bd = TBlockCSR.from_padded(t_data, t_partition.balanced(64, 2))
    _assert_block_csr_equal(r_bd, t_bd)


def test_block_csr_to_and_on_demand_counts():
    _, t = _pair(517, 41, 11, 0)
    bd = TBlockCSR.from_padded(t, t_partition.balanced(517, 3))
    moved = bd.to("cpu")
    assert moved.device == torch.device("cpu")
    bare = dataclasses.replace(bd, nnz_col=None)
    for l in range(3):
        assert torch.equal(bare.nnz_col_block(l), bd.nnz_col_block(l))
    assert bd.nnz_total() == t.nnz_total()


@pytest.mark.parametrize("q", [1, 4, 8])
def test_local_scatter_is_bitwise_reference(q):
    r, t = _pair()
    r_bd = RBlockCSR.from_padded(r, r_partition.balanced(r.dim, q))
    t_bd = TBlockCSR.from_padded(t, t_partition.balanced(t.dim, q))
    coeffs = np.random.default_rng(q).normal(size=r.num_instances).astype(np.float32)
    scatter = jax.jit(r_local_scatter, static_argnums=3)
    for l in range(q):
        want = scatter(r_bd.indices[l], r_bd.values[l], jnp.asarray(coeffs), r_bd.block_dims[l])
        got = t_local_scatter(t_bd.indices[l], t_bd.values[l], torch.from_numpy(coeffs),
                              t_bd.block_dims[l])
        assert np.asarray(want).tobytes() == got.numpy().tobytes()
    want = jax.jit(r_sparse.scatter_grad, static_argnums=3)(
        r.indices, r.values, jnp.asarray(coeffs), r.dim)
    got = t_sparse.scatter_grad(t.indices, t.values, torch.from_numpy(coeffs), t.dim)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def _assert_margins_close(want, got, w, idx, val):
    scale = np.sum(np.abs(w[idx] * val), axis=-1)
    assert np.all(np.abs(np.asarray(want) - _np(got)) <= MARGIN_RTOL * scale)


@pytest.mark.parametrize("q", [1, 8])
def test_local_margins_within_tolerance(q):
    r, t = _pair()
    r_bd = RBlockCSR.from_padded(r, r_partition.balanced(r.dim, q))
    t_bd = TBlockCSR.from_padded(t, t_partition.balanced(t.dim, q))
    w = np.random.default_rng(q).normal(size=r.dim).astype(np.float32)
    bounds = r_bd.partition.bounds
    for l in range(q):
        wl = w[bounds[l]:bounds[l + 1]]
        want = jax.jit(r_local_margins)(r_bd.indices[l], r_bd.values[l], jnp.asarray(wl))
        got = t_local_margins(t_bd.indices[l], t_bd.values[l], torch.from_numpy(wl))
        _assert_margins_close(want, got, wl, t_bd.indices[l].numpy(), t_bd.values[l].numpy())
    want = jax.jit(r_sparse.margins_rows)(r.indices, r.values, jnp.asarray(w))
    got = t_sparse.margins_rows(t.indices, t.values, torch.from_numpy(w))
    _assert_margins_close(want, got, w, t.indices.numpy(), t.values.numpy())


def test_padded_csr_to_dense_matches_reference():
    r, t = _pair(97, 9, 5, 4)
    np.testing.assert_array_equal(r.to_dense(), t.to_dense())


# ---------------------------------------------------------------------------
# losses and regularizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["logistic", "squared_hinge", "hinge", "squared"])
def test_losses_match_reference(name):
    g = np.random.default_rng(1)
    s = (g.normal(size=512) * 4).astype(np.float32)
    y = np.sign(g.normal(size=512)).astype(np.float32)
    r, t = r_losses.LOSSES[name], t_losses.LOSSES[name]
    assert r.smoothness == t.smoothness
    for fn in ("value", "dvalue"):
        want = np.asarray(jax.jit(getattr(r, fn))(jnp.asarray(s), jnp.asarray(y)))
        got = getattr(t, fn)(torch.from_numpy(s), torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-30)


REGS = [("l2", 1e-3, 0.0), ("l1", 1e-3, 0.0), ("elastic_net", 1e-3, 1e-2), ("none", 0.0, 0.0)]


@pytest.mark.parametrize("name,lam,lam2", REGS)
def test_regularizers_match_reference(name, lam, lam2):
    g = np.random.default_rng(2)
    w = g.normal(size=300).astype(np.float32)
    w[:7] = 0.0
    r, t = r_losses.Regularizer(name, lam, lam2), t_losses.Regularizer(name, lam, lam2)
    for attr in ("is_smooth", "smooth_lam", "prox_l1", "prox_l2"):
        assert getattr(r, attr) == getattr(t, attr)
    np.testing.assert_allclose(float(t.value(torch.from_numpy(w))), float(r.value(jnp.asarray(w))),
                               rtol=LOSS_RTOL)
    for fn in ("grad", "smooth_grad"):
        np.testing.assert_allclose(getattr(t, fn)(torch.from_numpy(w)).numpy(),
                                   np.asarray(getattr(r, fn)(jnp.asarray(w))), rtol=LOSS_RTOL)
    for eta in (0.25, 0.0):
        want = jax.jit(r.prox)(jnp.asarray(w), jnp.float32(eta))
        got = t.prox(torch.from_numpy(w), torch.tensor(eta, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=0)


def test_soft_threshold_matches_reference():
    v = np.random.default_rng(3).normal(size=1000).astype(np.float32)
    want = np.asarray(jax.jit(r_losses.soft_threshold)(jnp.asarray(v), jnp.float32(0.3)))
    got = t_losses.soft_threshold(torch.from_numpy(v), torch.tensor(0.3, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# dist: tree schedules, meters, closed forms, backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", list(range(1, 18)))
def test_tree_schedules_match_reference(q):
    assert r_tree.tree_schedule(q) == t_tree.tree_schedule(q)
    assert r_tree.broadcast_schedule(q) == t_tree.broadcast_schedule(q)
    assert r_meter.tree_rounds(q) == t_meter.tree_rounds(q)
    parts = np.random.default_rng(q).normal(size=(q, 33)).astype(np.float32)
    want = r_tree.tree_order_sum([jnp.asarray(p) for p in parts])
    got = t_tree.tree_order_sum([torch.from_numpy(p) for p in parts])
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_simulate_tree_sum_meters_like_reference():
    parts = np.random.default_rng(5).normal(size=(6, 4)).astype(np.float32)
    rm, tm = r_meter.CommMeter(), t_meter.CommMeter()
    want = r_tree.simulate_tree_sum([jnp.asarray(p) for p in parts], meter=rm)
    got = t_tree.simulate_tree_sum([torch.from_numpy(p) for p in parts], meter=tm)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()
    assert rm.state_dict() == tm.state_dict()


def test_cost_model_closed_forms_match_reference():
    rc, tc = r_costs.COSTS, t_costs.COSTS
    kw = dict(n=19_954, d=1_355_191, nnz=455)
    for method in ("serial", "fdsvrg", "fd_saga", "fd_bcd", "dsvrg", "synsvrg",
                   "asysvrg", "pslite_sgd"):
        for q in (1, 2, 8, 16):
            for u in (1, 4):
                for m in (None, 2000):
                    assert rc.outer_cost(method, q=q, u=u, inner_steps=m, **kw) == \
                        tc.outer_cost(method, q=q, u=u, inner_steps=m, **kw)
            assert rc.init_cost(method, n=kw["n"], nnz=455, q=q) == \
                tc.init_cost(method, n=kw["n"], nnz=455, q=q)
    for fn, args in (("fd_fullgrad", dict(n=100, nnz=7, q=4, k=2)),
                     ("fd_inner_step", dict(nnz=7, q=4, u=3)),
                     ("dsvrg_epoch", dict(m=5, nnz=7, d=50, u=2))):
        assert dataclasses.astuple(getattr(rc, fn)(**args)) == \
            dataclasses.astuple(getattr(tc, fn)(**args))
    with pytest.raises(ValueError, match="unknown method"):
        tc.outer_cost("nope", n=1, d=1, nnz=1, q=1)


def _drive_backend(mod, cls_name, parts):
    if cls_name == "ShardMapBackend":  # its interpret mode: no devices, no group
        backend = (r_shardmap if mod is r_coll else t_shardmap).ShardMapBackend(
            q=4, interpret=True)
    else:
        backend = getattr(mod, cls_name)(4)
    out = backend.all_reduce(parts)
    backend.meter_tree(payload=10, steps=3)
    backend.p2p(5, "abort", rounds=2)
    backend.charge(flops=1e6, scalars=40, rounds=2)
    backend.charge_seconds(0.5)
    backend.charge_cost(r_costs.PhaseCost(flops=2e5, scalars=8, rounds=4), steps=7)
    return out, backend


@pytest.mark.parametrize("cls_name", ["LocalBackend", "SimBackend", "ShardMapBackend"])
def test_backends_meter_like_reference(cls_name):
    parts = np.random.default_rng(6).normal(size=(4, 5)).astype(np.float32)
    r_out, r_b = _drive_backend(r_coll, cls_name, [jnp.asarray(p) for p in parts])
    t_out, t_b = _drive_backend(t_coll, cls_name, [torch.from_numpy(p) for p in parts])
    assert np.asarray(r_out).tobytes() == t_out.numpy().tobytes()
    assert r_b.meter.state_dict() == t_b.meter.state_dict()
    assert r_b.meter.snapshot() == t_b.meter.snapshot()
    assert r_b.modeled_time_s == t_b.modeled_time_s
    assert r_b.tree_rounds == t_b.tree_rounds
    assert r_b.report("m").to_dict() == t_b.report("m").to_dict()
    assert isinstance(t_b, t_coll.Collectives)
    with pytest.raises(ValueError, match="one partial per worker"):
        t_b.all_reduce([torch.zeros(2)])
    assert r_metering.reports_to_json({"m": r_b.report("m")}) == \
        t_metering.reports_to_json({"m": t_b.report("m")})


def test_cluster_model_and_meter_match_reference():
    rm, tm = r_meter.CommMeter(), t_meter.CommMeter()
    for m in (rm, tm):
        m.tree_reduce_broadcast(8, payload=3, steps=4)
        m.point_to_point(11)
        m.record("ring", 7, 3)
    assert rm.state_dict() == tm.state_dict()
    tm2 = t_meter.CommMeter()
    tm2.load_state(tm.state_dict())
    assert tm2.state_dict() == tm.state_dict()
    kw = dict(critical_flops=3e7, critical_scalars=1234, rounds=6)
    assert r_meter.ClusterModel().time(**kw) == t_meter.ClusterModel().time(**kw)


# ---------------------------------------------------------------------------
# driver pieces: sample stream, reporting, failure types, devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("option", ["I", "II"])
def test_sample_stream_matches_reference(option):
    r_rng, t_rng = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(3):
        a = r_driver.draw_samples(r_rng, 997, 50, 4)
        b = t_driver.draw_samples(t_rng, 997, 50, 4)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert r_driver.option_mask(r_rng, 50, option).tobytes() == \
            t_driver.option_mask(t_rng, 50, option).tobytes()


@pytest.mark.parametrize("name,lam,lam2", REGS)
def test_same_iterate_reporting_matches_reference(name, lam, lam2):
    g = np.random.default_rng(8)
    s = g.normal(size=200).astype(np.float32)
    y = np.sign(g.normal(size=200)).astype(np.float32)
    w = (g.normal(size=300) * 0.1).astype(np.float32)
    z = (g.normal(size=300) * 0.01).astype(np.float32)
    r_reg, t_reg = r_losses.Regularizer(name, lam, lam2), t_losses.Regularizer(name, lam, lam2)
    r_eval = r_driver.make_same_iterate_eval(jnp.asarray(y), r_losses.logistic, r_reg, 0.25)
    t_eval = t_driver.make_same_iterate_eval(torch.from_numpy(y), t_losses.logistic, t_reg, 0.25)
    want = r_eval(jnp.asarray(w), jnp.asarray(z), jnp.asarray(s))
    got = t_eval(torch.from_numpy(w), torch.from_numpy(z), torch.from_numpy(s))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_failure_types_and_policy_validation():
    assert issubclass(t_driver.DivergenceError, FaultError)
    assert issubclass(FaultError, RuntimeError)
    for bad in (dict(max_epoch_retries=-1), dict(eta_backoff=0.0), dict(divergence_factor=1.0)):
        with pytest.raises(ValueError):
            t_driver.RecoveryPolicy(**bad)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t = _pair(64, 8, 4, 0)
    cfg = SVRGConfig(eta=0.1, inner_steps=2, outer_iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fdsvrg(t, t_partition.balanced(64, 2), t_losses.logistic, t_losses.l2(1e-3), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serial_svrg(t, t_losses.logistic, t_losses.l2(1e-3), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_driver.resolve_device("cuda")
    assert t_driver.resolve_device("cpu") == torch.device("cpu")


def test_resolve_init_w():
    w = t_driver.resolve_init_w(None, 5, torch.float32, torch.device("cpu"))
    assert torch.equal(w, torch.zeros(5))
    w = t_driver.resolve_init_w(np.arange(5, dtype=np.float64), 5, torch.float32,
                                torch.device("cpu"))
    assert w.dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        t_driver.resolve_init_w(np.zeros(4), 5, torch.float32, torch.device("cpu"))


def test_convert_feeds_identical_bytes_and_validates():
    r, _ = _pair(97, 9, 5, 4)
    r_bd = RBlockCSR.from_padded(r, r_partition.balanced(97, 3))
    t_bd = convert.block_csr(
        [np.asarray(i) for i in r_bd.indices], [np.asarray(v) for v in r_bd.values],
        np.asarray(r_bd.labels), r_bd.partition.bounds, r_bd.dim, r_bd.nnz_max,
        [np.asarray(c) for c in r_bd.nnz_col],
    )
    _assert_block_csr_equal(r_bd, t_bd)
    assert convert.init_w(np.ones(3, np.float32)).dtype == torch.float32
    with pytest.raises(TypeError):
        convert.init_w(np.ones(3))
    with pytest.raises(ValueError, match="local ids"):
        convert.block_csr([np.full((2, 2), 40, np.int32)], [np.ones((2, 2), np.float32)],
                          np.ones(2, np.float32), (0, 10), 10)
    with pytest.raises(ValueError, match="feature ids"):
        convert.padded_csr(np.full((2, 2), 10, np.int32), np.ones((2, 2), np.float32),
                           np.ones(2, np.float32), 10)


# ---------------------------------------------------------------------------
# guards: the port and chip_smoke.py stand alone
# ---------------------------------------------------------------------------


def _port_modules():
    pkg = ROOT / "src" / "repro_torch"
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_no_jax_and_no_reference():
    mods = list(_port_modules())
    assert "repro_torch.kernels.ops" in mods and "repro_torch.core.fdsvrg" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.') or m.startswith('jaxlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_nothing_of_the_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert any(n.startswith("repro_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in ("repro", "jax", "jaxlib")]
    assert not bad, bad


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], env=env, capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
