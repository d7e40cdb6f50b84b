"""The multi-device driver's rank code and its card-side cases.

The functions each spawned rank runs (``spawn_ranks`` pickles them by
reference, so a rank imports this module, which imports no JAX), shared
with ``tests/test_torch_shardmap.py``, which holds the driver against the
reference on the CPU.  The ``cuda``-marked cases here run gloo ranks on
one card (each collective's payload staged through host memory): bitwise
``run_fdsvrg(q=4, use_kernels=True)`` on the card, the per-rank launches
of the closed forms; a one-rank NCCL group, psum and butterfly bitwise
``run_fdsvrg(q=1)``; the NCCL refusal of two ranks on one card; and a
multi-rank NCCL run, which needs two cards.  They skip without a card.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import api as t_api
from repro_torch.core import losses as t_losses
from repro_torch.core.fdsvrg import SVRGConfig as TConfig
from repro_torch.core.fdsvrg import run_fdsvrg
from repro_torch.core.fdsvrg_shardmap import (
    FDSVRGShardedConfig,
    make_fullgrad,
    make_outer_iteration,
    run_fdsvrg_sharded,
)
from repro_torch.core.partition import balanced
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.dist import ShardMapBackend, tree_order_sum
from repro_torch.dist import shardmap as t_shardmap
from repro_torch.dist.launch import spawn_ranks
from repro_torch.dist.tree import collective_permute_tree
from repro_torch.kernels import ops

DATA = dict(dim=512, num_instances=64, nnz_per_instance=8, seed=0)
RUN = dict(eta=0.2, inner_steps=12, batch_size=2, lam=1e-3)
OUTERS, SEED = 2, 3
Q = 4
OBJ_RTOL = 1e-5
W_ATOL = 1e-5  # psum against butterfly
REF_W_RTOL, REF_W_ATOL = 2e-4, 2e-6  # against the reference's drivers
SPAWN_S = 120.0


def _cfg(data, **kw) -> FDSVRGShardedConfig:
    return FDSVRGShardedConfig(dim=data.dim, num_instances=data.num_instances,
                               nnz_max=data.nnz_max, **{**RUN, **kw})


def _fd(data, q, use_kernels=True, device="cpu"):
    """The port's simulation driver at the sharded runs' settings."""
    cfg = TConfig(eta=RUN["eta"], inner_steps=RUN["inner_steps"], outer_iters=OUTERS,
                  batch_size=RUN["batch_size"], seed=SEED)
    return run_fdsvrg(data, balanced(data.dim, q), t_losses.logistic,
                      t_losses.l2(RUN["lam"]), cfg, use_kernels=use_kernels, device=device)


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().numpy().tobytes()


def _partials(q: int, width: int = 33, seed: int = 11) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed + q)
    scale = 10.0 ** rng.integers(-3, 4, size=(q, 1))
    return [torch.from_numpy(p) for p in (rng.normal(size=(q, width)) * scale)
            .astype(np.float32)]


def _rank_collectives(mesh):
    """On each of 4 ranks: the butterfly over groups of 1, 2 and 4 ranks
    and over a 2 x 2 mesh, psum, the gather, the guards that need a real
    mesh, and the NCCL shared-device refusal (transport and device
    identity stubbed: gloo carries the store traffic)."""
    rank = dist.get_rank()
    out = {}
    for size in (1, 2, 4):
        lo = rank // size * size
        members = list(range(lo, lo + size))
        groups = [dist.new_group(list(range(g, g + size))) for g in range(0, Q, size)]
        group = groups[rank // size]
        parts = _partials(size)
        got = collective_permute_tree(parts[rank - lo], group, size, members)
        out[f"butterfly_{size}"] = _bits(got) == _bits(tree_order_sum(parts))
    parts = _partials(Q)
    world = ShardMapBackend(mesh=mesh, tree_mode="psum")
    summed = world.device_all_reduce(parts[rank])
    out["psum_err"] = float(torch.max(torch.abs(summed - tree_order_sum(parts))
                                      / torch.clamp_min(torch.abs(tree_order_sum(parts)), 1e-30)))
    out["psum_is_a_copy"] = summed is not parts[rank] and torch.equal(parts[rank], _partials(Q)[rank])
    sizes = balanced(10, Q).block_sizes()
    mine = torch.arange(sum(sizes[:rank]), sum(sizes[:rank + 1]), dtype=torch.float32)
    out["gather"] = torch.equal(world.device_all_gather(mine, sizes), torch.arange(10.0))
    try:  # an untimed backend keeps no collective time
        out["untimed"] = world.collective_s
    except ValueError as err:
        out["untimed"] = str(err)
    from torch.distributed.device_mesh import DeviceMesh

    grid = DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=("data", "model"))
    flat = ShardMapBackend(mesh=grid, feature_axes=("data", "model"), tree_mode="butterfly")
    out["grid_q"] = flat.q
    out["grid_worker"] = flat.device_worker_id()
    out["grid_butterfly"] = _bits(flat.device_all_reduce(parts[flat.device_worker_id()])) \
        == _bits(tree_order_sum(parts))
    refusals = []
    for make in (lambda: world.all_reduce([torch.ones(2)] * Q),
                 lambda: ShardMapBackend(mesh=grid, feature_axes=("model",)),
                 lambda: ShardMapBackend(mesh=mesh, feature_axes=("data", "model")),
                 lambda: make_outer_iteration(mesh, _cfg(t_make(**DATA)), ("model",),
                                              backend=flat)):
        try:
            make()
            refusals.append(None)
        except ValueError as err:
            refusals.append(str(err))
    out["refusals"] = refusals
    stubs = (t_shardmap._transport, t_shardmap._device_identity)
    t_shardmap._transport = lambda group, device: "nccl"
    t_shardmap._device_identity = lambda: {"host": "h", "device": "cuda:0", "name": "card",
                                           "uuid": "GPU-same"}
    try:
        ShardMapBackend(mesh=mesh)
        out["nccl_refusal"] = None
    except ValueError as err:
        out["nccl_refusal"] = str(err)
    finally:
        t_shardmap._transport, t_shardmap._device_identity = stubs
    every = [None] * Q
    dist.all_gather_object(every, out)
    return every


def _rank_runs(mesh, data, device):
    """On each rank: the kernel-route butterfly run (twice on the card),
    the plain butterfly run, a psum run (its collectives timed) and
    ``solve(mesh=)``; rank 0 returns every rank's bits of w and s0 beside
    its own results."""
    from repro_torch.kernels import ops as rank_ops

    q = mesh.size()
    axes = ("model",)
    runs, bits = {}, {}
    for name, kw in (("butterfly", dict(tree_mode="butterfly")),
                     ("butterfly_plain", dict(tree_mode="butterfly", use_kernels=False)),
                     ("psum", dict(tree_mode="psum"))):
        cfg = _cfg(data, **kw)
        backend = ShardMapBackend(mesh=mesh, feature_axes=axes, tree_mode=cfg.tree_mode,
                                  timed=name == "psum")
        rank_ops.reset_launch_counts()
        res = run_fdsvrg_sharded(data, mesh, cfg, axes, outer_iters=OUTERS, seed=SEED,
                                 backend=backend, device=device)
        launches, staged = rank_ops.launch_counts(), backend.staged
        lo, hi = balanced(data.dim, q).block(backend.device_worker_id())
        block = BlockCSR.from_padded(data, balanced(data.dim, q)).one_block(
            backend.device_worker_id())
        _, s0 = make_fullgrad(mesh, cfg, axes, backend)(res.w[lo:hi].contiguous().to(device),
                                                        block.to(device))
        runs[name] = {"w": res.w.cpu(), "objectives": res.objectives().tolist(),
                      "grad_norms": [h.grad_norm for h in res.history],
                      "meter": res.meter.state_dict(), "modeled": backend.modeled_time_s,
                      "launches": launches, "staged": staged,
                      "collective_s": backend.collective_s if backend.timed else None}
        bits[name] = (_bits(res.w), _bits(s0))
    res = t_api.solve(t_api.ExperimentSpec(
        method="fdsvrg_sharded", data=data, mesh=mesh, tree_mode="butterfly",
        reg=t_losses.l2(RUN["lam"]), eta=RUN["eta"], batch_size=RUN["batch_size"],
        inner_steps=RUN["inner_steps"], outer_iters=OUTERS, seed=SEED, device=device))
    bits["solve"] = (_bits(res.w), b"")
    runs["solve"] = {"w": res.w.cpu(), "objectives": res.objectives().tolist()}
    try:  # a mesh on a method that does not run on one (the reference's check)
        t_api.solve(t_api.ExperimentSpec(method="fdsvrg", data=data, mesh=mesh, device=device))
        runs["mesh_on_fdsvrg"] = None
    except ValueError as err:
        runs["mesh_on_fdsvrg"] = str(err)
    every = [None] * q
    dist.all_gather_object(every, bits)
    return {"runs": runs, "bits": every}



def _rank_fails(mesh):
    """Rank 1 raises; the others wait for it at a barrier."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 raised on purpose")
    dist.barrier()


def _rank_sleeps(mesh):
    import time

    time.sleep(600)

# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gloo_ranks_on_one_card_are_the_kernel_path_bitwise(cuda_device, tmp_path):
    """4 gloo ranks on one card, each payload staged through host memory:
    bitwise ``run_fdsvrg(q=4, use_kernels=True)`` on the card, the
    per-rank launches of the closed forms."""
    t_data = t_make(**DATA)
    out = spawn_ranks(Q, _rank_runs, t_data, "cuda:0", timeout_s=SPAWN_S,
                      workdir=str(tmp_path))
    fd = _fd(t_data, Q, True, cuda_device)
    run = out["runs"]["butterfly"]
    assert torch.equal(run["w"], fd.w.cpu())
    assert run["objectives"] == fd.objectives().tolist()
    assert len({b["butterfly"] for b in out["bits"]}) == 1
    m, snaps = RUN["inner_steps"] * OUTERS, OUTERS + 1
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update(sparse_margin=snaps + m, logistic_grad=snaps + m, block_scatter=snaps,
                prox_update=m)
    assert run["launches"] == want
    # One staged all-reduce a step and a snapshot, two gathers an outer.
    assert run["staged"] == m + snaps + 2 * OUTERS + 1
    # The timed psum run's collectives, read from CUDA events, take part of its wall.
    assert 0.0 < out["runs"]["psum"]["collective_s"]


def _rank_nccl(mesh, data):
    """psum and butterfly on an NCCL group: the rank's w and objectives."""
    out = {}
    for mode in ("psum", "butterfly"):
        res = run_fdsvrg_sharded(data, mesh, _cfg(data, tree_mode=mode), ("model",),
                                 outer_iters=OUTERS, seed=SEED, device="cuda")
        out[mode] = (res.w.cpu(), res.objectives().tolist())
    return out


@pytest.mark.cuda
def test_one_rank_nccl_group_on_card(cuda_device, tmp_path):
    t_data = t_make(**DATA)
    out = spawn_ranks(1, _rank_nccl, t_data, backend="nccl", device="cuda:0",
                      timeout_s=SPAWN_S, workdir=str(tmp_path))
    fd = _fd(t_data, 1, True, cuda_device)
    for mode in ("psum", "butterfly"):
        assert torch.equal(out[mode][0], fd.w.cpu()), mode
        assert out[mode][1] == fd.objectives().tolist(), mode


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(cuda_device, tmp_path):
    """Refused before any rank starts (a rank binds its group to its card
    at init, where NCCL itself refuses a shared card)."""
    t_data = t_make(**DATA)
    with pytest.raises(ValueError, match="NCCL runs one rank per device"):
        spawn_ranks(2, _rank_nccl, t_data, backend="nccl", device="cuda:0",
                    timeout_s=SPAWN_S, workdir=str(tmp_path))
    assert not any(tmp_path.iterdir())


@pytest.mark.cuda
def test_multi_rank_nccl_is_run_fdsvrg_bitwise(cuda_device, tmp_path):
    """One rank per card, the largest power of two of them (at most 4)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two CUDA devices, found {cards}")
    q = min(4, 1 << (cards.bit_length() - 1))
    t_data = t_make(**DATA)
    out = spawn_ranks(q, _rank_nccl, t_data, backend="nccl", device="cuda",
                      timeout_s=SPAWN_S, workdir=str(tmp_path))
    fd = _fd(t_data, q, True, cuda_device)
    assert torch.equal(out["butterfly"][0], fd.w.cpu())
    assert out["butterfly"][1] == fd.objectives().tolist()
    np.testing.assert_allclose(out["psum"][1], fd.objectives().tolist(), rtol=OBJ_RTOL)
