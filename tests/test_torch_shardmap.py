"""The multi-device driver (``repro_torch.core.fdsvrg_shardmap``,
``repro_torch.dist.shardmap``, ``repro_torch.dist.launch``) held against
the reference's shard_map driver and against the port's own simulation
driver, on the CPU.

One process per rank: the spawned cases start 4 gloo ranks on this host
(``spawn_ranks``, a ``file://`` store under ``tmp_path``, 120 s each) and
run every multi-rank check inside them.  Exact: the butterfly against
``tree_order_sum`` (the same adds in the same rounds), a butterfly run
against ``run_fdsvrg`` at the same q and seed (w, objectives, every rank
alike), meters and modeled time against the reference's (modeled time at
rtol 1e-12).  Stated tolerances: a psum run within objective rtol 1e-5 and
``w`` atol 1e-5 of the butterfly run (gloo's all-reduce adds in its own
order); against the reference's drivers, objectives rtol 1e-5 and ``w``
rtol 2e-4 / atol 2e-6 (``tests/test_fdsvrg_shardmap.py``'s tolerances;
torch and XLA round the margin sums differently).

The ranks run code from ``tests/test_torch_shardmap_ranks.py``, which
imports no JAX and holds the ``cuda``-marked cases.
"""

import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as r_losses
from repro.core.fdsvrg import SVRGConfig as RConfig
from repro.core.fdsvrg import run_fdsvrg as r_run_fdsvrg
from repro.core.fdsvrg_shardmap import FDSVRGShardedConfig as RShardedConfig
from repro.core.fdsvrg_shardmap import make_outer_iteration as r_make_outer
from repro.core.fdsvrg_shardmap import run_fdsvrg_sharded as r_run_sharded
from repro.core.partition import balanced as r_balanced
from repro.data.block_csr import BlockCSR as RBlockCSR
from repro.data.synthetic import make_sparse_classification as r_make
from repro.dist import ShardMapBackend as RShardMapBackend

from repro_torch.core import losses as t_losses
from repro_torch.core.fdsvrg import SVRGConfig as TConfig
from repro_torch.core.fdsvrg import fdsvrg_worker_simulation
from repro_torch.core.fdsvrg_shardmap import (
    input_shardings,
    make_outer_iteration,
    run_fdsvrg_sharded,
)
from repro_torch.core.partition import balanced
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.dist import ShardMapBackend, SimBackend, tree_order_sum
from repro_torch.dist.launch import RankError, spawn_ranks
from repro_torch.dist.tree import collective_permute_tree

from test_torch_shardmap_ranks import (  # the ranks' code, which imports no JAX
    DATA,
    OBJ_RTOL,
    OUTERS,
    Q,
    REF_W_ATOL,
    REF_W_RTOL,
    RUN,
    SEED,
    SPAWN_S,
    W_ATOL,
    _bits,
    _cfg,
    _fd,
    _partials,
    _rank_collectives,
    _rank_fails,
    _rank_runs,
    _rank_sleeps,
)


def _data():
    return r_make(**DATA), t_make(**DATA)


# ---------------------------------------------------------------------------
# The butterfly's bits, the backend's guards, interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_butterfly_rounds_are_tree_order_sum_bitwise(q):
    """The butterfly's arithmetic, replayed round by round on the host (what
    ``collective_permute_tree`` computes on every rank): each worker's
    result has the bits of ``tree_order_sum`` of the q partials.  The
    spawned cases run the real collective at q = 1, 2, 4; the card runs it
    at q = 8."""
    parts = _partials(q)
    out = list(parts)
    stride = 1
    while stride < q:
        out = [out[i] + out[i ^ stride] for i in range(q)]
        stride *= 2
    want = tree_order_sum(parts)
    for got in out:
        assert _bits(got) == _bits(want)


def test_butterfly_refuses_a_size_that_is_not_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        collective_permute_tree(torch.ones(2), None, 3)


def test_shardmap_backend_guards():
    """The reference's guards (``tests/test_dist_backends.py:126-150``);
    those that need a real mesh run in ``test_spawned_collectives``."""
    b = ShardMapBackend(q=2, interpret=True)
    for call in (lambda: b.device_all_reduce(torch.ones(())),
                 lambda: b.device_all_gather(torch.ones(2), [2, 2]),
                 b.device_worker_id):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError, match="tree_mode"):
        ShardMapBackend(q=2, tree_mode="ring")
    with pytest.raises(ValueError, match="exactly one"):
        ShardMapBackend()
    with pytest.raises(ValueError, match="DeviceMesh"):
        ShardMapBackend(mesh=object())
    one = ShardMapBackend(q=1)
    x = torch.arange(3.0)
    assert one.device_all_reduce(x) is x and one.device_all_gather(x, [3]) is x
    assert one.interpret and one.staged == 0
    # A driver given a backend of more workers than its (absent) mesh.
    _, t_data = _data()
    with pytest.raises(ValueError, match="one rank"):
        make_outer_iteration(None, _cfg(t_data), backend=b)


@pytest.mark.parametrize("kind", ["sim", "shardmap-interpret"])
def test_worker_simulation_identical_across_backends(kind):
    """The reference's backend-equivalence suite, ``shardmap-interpret``
    included: the worker simulation over the interpret backend gives the
    SimBackend's iterates and meter, bit for bit."""
    _, t_data = _data()
    cfg = TConfig(eta=0.2, inner_steps=10, outer_iters=2, seed=13)
    part = balanced(t_data.dim, Q)
    backend = SimBackend(Q) if kind == "sim" else ShardMapBackend(q=Q, interpret=True)
    ref = fdsvrg_worker_simulation(t_data, part, t_losses.logistic, t_losses.l2(1e-3), cfg,
                                   backend=SimBackend(Q), device="cpu")
    res = fdsvrg_worker_simulation(t_data, part, t_losses.logistic, t_losses.l2(1e-3), cfg,
                                   backend=backend, device="cpu")
    assert torch.equal(res.w, ref.w)
    assert res.meter.state_dict() == ref.meter.state_dict()
    n, m = t_data.num_instances, cfg.inner_steps
    assert res.meter.total_scalars == cfg.outer_iters * (2 * Q * n + 2 * Q * m)


# ---------------------------------------------------------------------------
# One rank, no process group (the reference's one-device mesh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_route", "plain"])
@pytest.mark.parametrize("tree_mode", ["psum", "butterfly"])
def test_one_rank_is_run_fdsvrg_bitwise(use_kernels, tree_mode):
    _, t_data = _data()
    res = run_fdsvrg_sharded(t_data, None, _cfg(t_data, use_kernels=use_kernels,
                                                 tree_mode=tree_mode),
                             outer_iters=OUTERS, seed=SEED, device="cpu")
    fd = _fd(t_data, 1, use_kernels)
    assert torch.equal(res.w, fd.w)
    assert res.objectives().tolist() == fd.objectives().tolist()
    assert [h.grad_norm for h in res.history] == [h.grad_norm for h in fd.history]
    assert res.meter.state_dict() == fd.meter.state_dict()


def _reference_one_device(r_data, reg_name="l2", lam=RUN["lam"]):
    from repro.dist.compat import make_mesh

    mesh = make_mesh((1,), ("model",))
    cfg = RShardedConfig(dim=r_data.dim, num_instances=r_data.num_instances,
                         nnz_max=r_data.nnz_max, eta=RUN["eta"],
                         inner_steps=RUN["inner_steps"], batch_size=RUN["batch_size"],
                         reg_name=reg_name, lam=lam)
    backend = RShardMapBackend(mesh=mesh, feature_axes=("model",))
    res = r_run_sharded(r_data, mesh, cfg, feature_axes=("model",), outer_iters=OUTERS,
                        seed=SEED, backend=backend)
    return mesh, cfg, backend, res


def test_one_rank_matches_the_reference_sharded_driver():
    """Against ``run_fdsvrg_sharded`` on a ``(1,)`` mesh, from a host copy
    of its ``w``."""
    r_data, t_data = _data()
    _, _, _, ref = _reference_one_device(r_data)
    for use_kernels in (True, False):
        res = run_fdsvrg_sharded(t_data, None, _cfg(t_data, use_kernels=use_kernels),
                                 outer_iters=OUTERS, seed=SEED, device="cpu")
        np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=REF_W_RTOL,
                                   atol=REF_W_ATOL)
        np.testing.assert_allclose(res.objectives(), ref.objectives(), rtol=OBJ_RTOL)


def test_one_rank_meters_like_the_reference():
    """Meters exact and modeled time at rtol 1e-12, record by record
    (``tests/test_fdsvrg_shardmap.py:128-197``), through a given backend
    whose meter the result returns."""
    r_data, t_data = _data()
    _, _, r_backend, ref = _reference_one_device(r_data)
    backend = ShardMapBackend(q=1)
    res = run_fdsvrg_sharded(t_data, None, _cfg(t_data), outer_iters=OUTERS, seed=SEED,
                             backend=backend, device="cpu")
    assert res.meter is backend.meter
    assert res.meter.state_dict() == ref.meter.state_dict()
    np.testing.assert_allclose(backend.modeled_time_s, r_backend.modeled_time_s, rtol=1e-12)
    assert backend.modeled_time_s > 0.0
    for h, r in zip(res.history, ref.history, strict=True):
        assert (h.outer, h.comm_scalars, h.comm_rounds) == (r.outer, r.comm_scalars,
                                                            r.comm_rounds)
        np.testing.assert_allclose(h.modeled_time_s, r.modeled_time_s, rtol=1e-12)


@pytest.mark.parametrize("reg_name,lam", [("l2", 1e-3), ("l1", 2e-3)])
def test_outer_iteration_gnorm_matches_the_reference(reg_name, lam):
    """``make_outer_iteration``: the snapshot residual and the next iterate
    against the reference's fused step on a ``(1,)`` mesh, same samples."""
    r_data, t_data = _data()
    r_mesh, r_cfg, _, _ = _reference_one_device(r_data, reg_name, lam)
    r_step = r_make_outer(r_mesh, r_cfg, feature_axes=("model",))
    r_bidx, r_bval = RBlockCSR.from_padded(r_data, r_balanced(r_data.dim, 1)).stacked()
    step = make_outer_iteration(None, _cfg(t_data, reg_name=reg_name, lam=lam))
    block = BlockCSR.from_padded(t_data, balanced(t_data.dim, 1)).one_block(0)
    rng = np.random.default_rng(7)
    w = torch.zeros(t_data.dim)
    r_w = jnp.zeros((r_data.dim,), jnp.float32)
    for _ in range(OUTERS):
        samples = rng.integers(0, t_data.num_instances,
                               size=(RUN["inner_steps"], RUN["batch_size"])).astype(np.int32)
        w, gnorm = step(w, block, samples)
        r_w, r_gnorm = r_step(r_w, r_bidx, r_bval, r_data.labels, jnp.asarray(samples))
        np.testing.assert_allclose(float(gnorm), float(r_gnorm), rtol=OBJ_RTOL)
        np.testing.assert_allclose(w.numpy(), np.asarray(r_w), rtol=REF_W_RTOL,
                                   atol=REF_W_ATOL)


def test_layouts_and_input_shardings():
    """``BlockCSR.stacked`` byte for byte the reference's; ``one_block`` is
    block l's tensors over its own features; the placements have the
    reference's arity."""
    from torch.distributed.tensor import Replicate, Shard

    r_data, t_data = _data()
    for q in (1, 3, 4):
        r_idx, r_val = RBlockCSR.from_padded(r_data, r_balanced(r_data.dim, q)).stacked()
        layout = BlockCSR.from_padded(t_data, balanced(t_data.dim, q))
        idx, val = layout.stacked()
        assert idx.numpy().tobytes() == np.asarray(r_idx).tobytes()
        assert val.numpy().tobytes() == np.asarray(r_val).tobytes()
        with pytest.raises(ValueError, match="budget"):
            layout.stacked(budget=1)
        for l in range(q):
            one = layout.one_block(l)
            assert (one.num_blocks, one.dim) == (1, layout.block_dims[l])
            assert one.indices[0] is layout.indices[l] and one.values[0] is layout.values[l]
            assert one.labels is layout.labels
            assert one.global_nnz_max() == t_data.nnz_max
    shardings = input_shardings(None)
    assert len(shardings) == 5  # w, block indices, block values, labels, samples
    assert shardings[0] == (Shard(0),) and shardings[3] == (Replicate(),)


@pytest.mark.parametrize("q", [1, 3, 4, 8])
def test_block_of_is_one_block_of_the_whole_layout(q):
    """``BlockCSR.block_of`` (what a rank builds for itself) holds block l
    of ``from_padded`` byte for byte, without the other blocks."""
    _, t_data = _data()
    part = balanced(t_data.dim, q)
    whole = BlockCSR.from_padded(t_data, part)
    for l in range(q):
        want, got = whole.one_block(l), BlockCSR.block_of(t_data, part, l)
        assert (got.num_blocks, got.dim, got.partition) == (1, want.dim, want.partition)
        assert got.global_nnz_max() == want.global_nnz_max() == t_data.nnz_max
        for a, b in ((got.indices[0], want.indices[0]), (got.values[0], want.values[0]),
                     (got.nnz_col[0], want.nnz_col[0]), (got.labels, want.labels)):
            assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()
    with pytest.raises(ValueError, match="partition covers"):
        BlockCSR.block_of(t_data, balanced(t_data.dim + 1, q), 0)


def test_sharded_driver_refusals():
    _, t_data = _data()
    cfg = _cfg(t_data)
    with pytest.raises(ValueError, match="block="):
        run_fdsvrg_sharded(None, None, cfg, device="cpu")
    two = BlockCSR.from_padded(t_data, balanced(t_data.dim, 2))
    with pytest.raises(ValueError, match="features"):
        run_fdsvrg_sharded(None, None, cfg, block=two, device="cpu")
    with pytest.raises(ValueError, match="features"):
        run_fdsvrg_sharded(None, None, cfg, block=two.one_block(0), device="cpu")
    with pytest.raises(ValueError, match="one rank"):
        run_fdsvrg_sharded(t_data, None, cfg, backend=ShardMapBackend(q=2), device="cpu")
    wide = BlockCSR.from_padded(t_data, balanced(t_data.dim, 1)).one_block(0)
    import dataclasses

    wide = dataclasses.replace(wide, values=(wide.values[0].double(),))
    with pytest.raises(ValueError, match="float32"):
        run_fdsvrg_sharded(None, None, cfg, block=wide, device="cpu")
    from repro_torch import api as t_api

    with pytest.raises(ValueError, match="tree_mode must be one of"):
        t_api.solve(t_api.ExperimentSpec(method="fdsvrg_sharded", data=t_data,
                                         tree_mode="ring", device="cpu"))


# ---------------------------------------------------------------------------
# Spawned gloo ranks on this host (4 processes; each spawn 120 s at most)
# ---------------------------------------------------------------------------


def test_spawned_collectives(tmp_path):
    every = spawn_ranks(Q, _rank_collectives, device="cpu", timeout_s=SPAWN_S,
                        workdir=str(tmp_path))
    for rank, out in enumerate(every):
        assert out["butterfly_1"] and out["butterfly_2"] and out["butterfly_4"], (rank, out)
        assert out["psum_err"] <= 1e-6 and out["psum_is_a_copy"], (rank, out)
        assert out["gather"]
        assert "timed=True" in out["untimed"]
        assert out["grid_q"] == Q and out["grid_butterfly"]
        assert out["grid_worker"] == rank  # row-major over ("data", "model")
        host, axes, extra, other = out["refusals"]
        assert "interpret=True" in host and "every dimension" in axes
        assert "every dimension" in extra and "different mesh" in other
        assert "NCCL runs one rank per device" in out["nccl_refusal"]
        assert "cuda:0" in out["nccl_refusal"]


def test_spawn_ranks_reports_failures_and_time_outs(tmp_path):
    """A failed rank's traceback comes back in the error, with the fate of
    the others; ranks still running at the time limit are killed."""
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 raised on purpose"):
        spawn_ranks(Q, _rank_fails, device="cpu", timeout_s=SPAWN_S,
                    workdir=str(tmp_path / "fails"))
    with pytest.raises(RankError, match="did not finish within 8 s; killed"):
        spawn_ranks(2, _rank_sleeps, device="cpu", timeout_s=8.0,
                    workdir=str(tmp_path / "sleeps"))
    assert time.monotonic() - t0 < SPAWN_S
    with pytest.raises(ValueError, match="backend"):
        spawn_ranks(2, _rank_sleeps, backend="mpi", device="cpu")


def test_spawn_ranks_runs_on_the_card_unless_asked(monkeypatch):
    """Like every entry point, ``spawn_ranks`` puts its ranks on ``cuda``
    by default and raises, before it starts a rank, where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        spawn_ranks(2, _rank_sleeps)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    _, t_data = _data()
    return spawn_ranks(Q, _rank_runs, t_data, "cpu", device="cpu", timeout_s=SPAWN_S,
                       workdir=str(tmp_path_factory.mktemp("ranks")))


def test_spawned_butterfly_is_run_fdsvrg_bitwise(spawned):
    """4 gloo ranks, butterfly: w, objectives and grad norms bit for bit the
    port's ``run_fdsvrg(q=4)`` (kernel route and plain path on the CPU),
    w and s0 the same bits on every rank, meters the simulation driver's."""
    _, t_data = _data()
    for name, use_kernels in (("butterfly", True), ("butterfly_plain", False)):
        run, fd = spawned["runs"][name], _fd(t_data, Q, use_kernels)
        assert torch.equal(run["w"], fd.w), name
        assert run["objectives"] == fd.objectives().tolist()
        assert run["grad_norms"] == [h.grad_norm for h in fd.history]
        assert run["meter"] == fd.meter.state_dict()
        assert len({b[name] for b in spawned["bits"]}) == 1, name
        assert set(run["launches"].values()) == {0}  # the CPU launches no kernel
        assert run["staged"] == 0


def test_spawned_psum_within_tolerance(spawned):
    psum, fly = spawned["runs"]["psum"], spawned["runs"]["butterfly"]
    np.testing.assert_allclose(psum["objectives"], fly["objectives"], rtol=OBJ_RTOL)
    np.testing.assert_allclose(psum["w"].numpy(), fly["w"].numpy(), atol=W_ATOL, rtol=0)
    assert psum["meter"] == fly["meter"]
    assert psum["collective_s"] > 0.0 and fly["collective_s"] is None  # timed=True only


def test_spawned_solve_on_each_rank(spawned):
    """``solve(ExperimentSpec(method="fdsvrg_sharded", mesh=mesh))`` on every
    rank: q from the mesh, bitwise the direct butterfly run."""
    assert len({b["solve"] for b in spawned["bits"]}) == 1
    assert "does not run on a mesh" in spawned["runs"]["mesh_on_fdsvrg"]
    assert spawned["bits"][0]["solve"][0] == spawned["bits"][0]["butterfly"][0]
    assert spawned["runs"]["solve"]["objectives"] == spawned["runs"]["butterfly"]["objectives"]


_REFERENCE_SHARDED = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={q}"
    import jax, numpy as np
    from repro.core.fdsvrg_shardmap import FDSVRGShardedConfig, run_fdsvrg_sharded
    from repro.data.synthetic import make_sparse_classification
    from repro.dist.compat import make_mesh

    assert jax.device_count() == {q}
    data = make_sparse_classification(**{data})
    cfg = FDSVRGShardedConfig(dim=data.dim, num_instances=data.num_instances,
                              nnz_max=data.nnz_max, tree_mode="butterfly", **{run})
    res = run_fdsvrg_sharded(data, make_mesh(({q},), ("model",)), cfg,
                             feature_axes=("model",), outer_iters={outers}, seed={seed})
    np.savez(sys.argv[1], w=np.asarray(res.w), objectives=res.objectives(),
             scalars=res.meter.total_scalars)
    """
)


def test_spawned_runs_match_the_reference(spawned, tmp_path):
    """The butterfly run against the reference's ``run_fdsvrg`` at q = 4 and
    against its shard_map driver on 4 host devices (a subprocess, as
    ``tests/test_fdsvrg_shardmap.py:261-318`` runs it)."""
    r_data, _ = _data()
    run = spawned["runs"]["butterfly"]
    rcfg = RConfig(eta=RUN["eta"], inner_steps=RUN["inner_steps"], outer_iters=OUTERS,
                   batch_size=RUN["batch_size"], seed=SEED)
    ref = r_run_fdsvrg(r_data, r_balanced(r_data.dim, Q), r_losses.logistic,
                       r_losses.l2(RUN["lam"]), rcfg)
    out = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src")))
    prog = _REFERENCE_SHARDED.format(q=Q, data=repr(DATA), run=repr(RUN), outers=OUTERS,
                                     seed=SEED)
    proc = subprocess.run([sys.executable, "-c", prog, str(out)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    sharded = np.load(out)
    for w, objectives in ((np.asarray(ref.w), ref.objectives()),
                          (sharded["w"], sharded["objectives"])):
        np.testing.assert_allclose(run["w"].numpy(), w, rtol=REF_W_RTOL, atol=REF_W_ATOL)
        np.testing.assert_allclose(run["objectives"], objectives, rtol=OBJ_RTOL)
    assert run["meter"] == ref.meter.state_dict()
    assert int(sharded["scalars"]) == ref.meter.total_scalars
