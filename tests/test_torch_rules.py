"""The port's update-rule family (``repro_torch.optim.update_rules``) held
against the reference's (``repro.optim.update_rules``), on the CPU.

* Multi-output ``w ∈ R^{d×k}`` (SVRG, plain path): against the
  reference's vmapped run, each column bit for bit the port's own scalar
  run on that column, ``[N, 1]`` labels bit for bit the 1-D path, the
  meter scaled by k, and the refusals (kernels, lazy steps, the rules
  without multi-output).
* FD-SAGA and FD-BCD at q in {2, 4}, l2 and l1, kernel route (the plain
  versions on the CPU) and plain path: every meter field exact, the §4.5
  closed forms (SAGA's one-time table init included), objectives and grad
  norms within rtol 1e-5, ``w`` within atol 1e-5.  SAGA's first epoch
  equals SVRG's bit for bit while no sample repeats; BCD is seed-free.
* Both refuse recovery, Option II and float64 data on the kernel route.

The ``cuda``-marked twins hold two kernel runs bitwise equal on the card,
the kernel route against the plain path within ``RUN_RTOL`` /
``RUN_W_RTOL``, and the launch counts exactly.
"""

import dataclasses
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as r_losses
from repro.core.fdsvrg import SVRGConfig as RConfig
from repro.core.partition import balanced as r_balanced
from repro.data.block_csr import BlockCSR as RBlockCSR
from repro.data.synthetic import make_sparse_classification as r_make
from repro.dist import ClusterModel as RCluster
from repro.dist import SimBackend as RSimBackend
from repro.optim import update_rules as r_rules

from repro_torch.core import losses as t_losses
from repro_torch.core.driver import RecoveryPolicy
from repro_torch.core.fdsvrg import SVRGConfig as TConfig
from repro_torch.core.partition import balanced as t_balanced
from repro_torch.data.block_csr import BlockCSR as TBlockCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.dist import COSTS
from repro_torch.dist import ClusterModel as TCluster
from repro_torch.dist import SimBackend as TSimBackend
from repro_torch.kernels import ops
from repro_torch.optim import update_rules as t_rules

OBJ_RTOL = 1e-5
W_ATOL = 1e-5
RUN_RTOL, RUN_W_RTOL = 1e-5, 1e-3
DATA = dict(dim=512, num_instances=96, nnz_per_instance=12, seed=3)
REGS = {"l2": (1e-3, 0.0), "l1": (1e-3, 0.0)}
RULE_MATRIX = list(itertools.product(["fd_saga", "fd_bcd"], [2, 4], REGS, [True, False]))


@functools.lru_cache(maxsize=None)
def _data():
    return r_make(**DATA), t_make(**DATA)


@functools.lru_cache(maxsize=None)
def _blocks(q):
    r_data, t_data = _data()
    return (RBlockCSR.from_padded(r_data, r_balanced(r_data.dim, q)),
            TBlockCSR.from_padded(t_data, t_balanced(t_data.dim, q)))


def _rule_cfg(name, q, cls, outers=3, seed=5):
    """The paper's M conventions: SAGA N/u steps an outer at u = 2, BCD one
    cycle over the q blocks and one more (the cursor crosses outers)."""
    if name == "fd_saga":
        return cls(eta=0.2, inner_steps=DATA["num_instances"] // 2, outer_iters=outers,
                   batch_size=2, seed=seed)
    return cls(eta=0.5, inner_steps=q + 1, outer_iters=outers, seed=seed)


@functools.lru_cache(maxsize=None)
def _reference_rule(name, q, reg):
    lam, lam2 = REGS[reg]
    ctx = r_rules.make_context(_blocks(q)[0], r_losses.logistic,
                               r_losses.Regularizer(reg, lam, lam2),
                               _rule_cfg(name, q, RConfig), backend=RSimBackend(q, RCluster()))
    return r_rules.run_with_rule(r_rules.RULES[name](), ctx)


@functools.lru_cache(maxsize=None)
def _port_rule(name, q, reg, use_kernels, device="cpu"):
    lam, lam2 = REGS[reg]
    ctx = t_rules.make_context(_blocks(q)[1].to(device), t_losses.logistic,
                               t_losses.Regularizer(reg, lam, lam2),
                               _rule_cfg(name, q, TConfig), backend=TSimBackend(q, TCluster()))
    return t_rules.run_with_rule(t_rules.RULES[name](use_kernels=use_kernels), ctx)


def _assert_runs_agree(ref, port):
    obj, r_obj = port.objectives(), ref.objectives()
    np.testing.assert_allclose(obj, r_obj, rtol=OBJ_RTOL)
    np.testing.assert_allclose([h.grad_norm for h in port.history],
                               [h.grad_norm for h in ref.history], rtol=OBJ_RTOL)
    np.testing.assert_allclose(port.w.cpu().numpy(), np.asarray(ref.w), rtol=0, atol=W_ATOL)
    assert port.meter.state_dict() == ref.meter.state_dict()
    for field in ("outer", "comm_scalars", "comm_rounds"):
        assert [getattr(h, field) for h in port.history] == \
            [getattr(h, field) for h in ref.history], field
    np.testing.assert_allclose([h.modeled_time_s for h in port.history],
                               [h.modeled_time_s for h in ref.history], rtol=1e-12)


# ---------------------------------------------------------------------------
# FD-SAGA / FD-BCD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,q,reg,use_kernels", RULE_MATRIX)
def test_rule_matches_reference(name, q, reg, use_kernels):
    ref, port = _reference_rule(name, q, reg), _port_rule(name, q, reg, use_kernels)
    _assert_runs_agree(ref, port)
    # The meter against the closed forms (SAGA's table init is once a run).
    n, nnz = DATA["num_instances"], _data()[1].nnz_max
    cfg = _rule_cfg(name, q, TConfig)
    t1, c1 = COSTS.outer_cost(name, n=n, d=DATA["dim"], nnz=nnz, q=q, u=cfg.batch_size,
                              inner_steps=cfg.inner_steps)
    t0, c0 = COSTS.init_cost(name, n=n, nnz=nnz, q=q)
    assert [h.comm_scalars for h in port.history] == [c0 + c1 * (t + 1) for t in range(3)]
    np.testing.assert_allclose(port.history[-1].modeled_time_s, t0 + 3 * t1, rtol=1e-12)
    assert port.objectives()[-1] < port.objectives()[0] < np.log(2.0)
    if use_kernels:
        plain = _port_rule(name, q, reg, False)
        np.testing.assert_allclose(port.objectives(), plain.objectives(), rtol=OBJ_RTOL)
        np.testing.assert_allclose(port.w.numpy(), plain.w.numpy(), rtol=0, atol=W_ATOL)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_saga_first_epoch_equals_svrg_first_epoch(use_kernels):
    """With the table taken from the snapshot, alpha[i] is the snapshot's
    derivative for every untouched i: while no sample repeats, FD-SAGA's
    direction is FD-SVRG's, bit for bit."""
    cfg = TConfig(eta=0.1, inner_steps=1, outer_iters=1, seed=9)
    block = _blocks(2)[1]
    saga = t_rules.run_with_rule(t_rules.SAGARule(use_kernels=use_kernels),
                                 t_rules.make_context(block, t_losses.logistic,
                                                      t_losses.l2(1e-3), cfg))
    svrg = t_rules.run_with_rule(t_rules.SVRGRule(use_kernels=use_kernels),
                                 t_rules.make_context(block, t_losses.logistic,
                                                      t_losses.l2(1e-3), cfg))
    assert torch.equal(saga.w, svrg.w)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bcd_is_deterministic_and_seed_free(use_kernels):
    q = 4
    runs = [
        t_rules.run_with_rule(
            t_rules.BCDRule(use_kernels=use_kernels),
            t_rules.make_context(_blocks(q)[1], t_losses.logistic, t_losses.l1(1e-4),
                                 TConfig(eta=0.5, inner_steps=q, outer_iters=3, seed=s)),
        )
        for s in (0, 123)
    ]
    assert torch.equal(runs[0].w, runs[1].w)


@pytest.mark.parametrize("rule_cls", [t_rules.SAGARule, t_rules.BCDRule])
def test_rules_reject_recovery_option_ii_and_float64_kernels(rule_cls):
    block = _blocks(2)[1]
    ctx = t_rules.make_context(block, t_losses.logistic, t_losses.l2(1e-3),
                               TConfig(eta=0.2, inner_steps=4, outer_iters=1))
    with pytest.raises(ValueError, match="recovery"):
        t_rules.run_with_rule(rule_cls(), ctx, recovery=RecoveryPolicy())
    ctx_ii = t_rules.make_context(block, t_losses.logistic, t_losses.l2(1e-3),
                                  TConfig(eta=0.2, inner_steps=4, outer_iters=1, option="II"))
    with pytest.raises(ValueError, match="Option I"):
        t_rules.run_with_rule(rule_cls(), ctx_ii)
    wide = dataclasses.replace(block, values=tuple(v.double() for v in block.values),
                               labels=block.labels.double())
    ctx64 = t_rules.make_context(wide, t_losses.logistic, t_losses.l2(1e-3),
                                 TConfig(eta=0.2, inner_steps=4, outer_iters=1))
    with pytest.raises(ValueError, match="float32"):
        t_rules.run_with_rule(rule_cls(), ctx64)
    res = t_rules.run_with_rule(rule_cls(use_kernels=False), ctx64)
    assert res.w.dtype == torch.float64 and np.isfinite(res.final_objective())


def test_rules_registry_names():
    assert set(t_rules.RULES) == set(r_rules.RULES) == {"svrg", "fd_saga", "fd_bcd"}
    for name, cls in t_rules.RULES.items():
        assert cls.name == name


# ---------------------------------------------------------------------------
# Multi-output w in R^{d x k}
# ---------------------------------------------------------------------------


def _multi_labels(k, seed=7):
    rng = np.random.default_rng(seed)
    y = rng.choice([-1.0, 1.0], size=(DATA["num_instances"], k))
    y[:, 0] = _data()[1].labels.numpy()  # one real column among the k
    return y.astype(np.float32)


def _multi(labels, loss_name, cfg_kw, q=2, use_kernels=False, metered=True):
    """(reference run, port run) on the same [N, k] (or [N]) labels."""
    r_block, t_block = _blocks(q)
    kw = dict(eta=0.2, outer_iters=3, seed=2, **cfg_kw)
    ref = r_rules.run_with_rule(r_rules.SVRGRule(), r_rules.make_context(
        dataclasses.replace(r_block, labels=jnp.asarray(labels)), r_losses.LOSSES[loss_name],
        r_losses.l2(1e-3), RConfig(**kw),
        backend=RSimBackend(q, RCluster()) if metered else None))
    port = t_rules.run_with_rule(t_rules.SVRGRule(use_kernels=use_kernels), t_rules.make_context(
        dataclasses.replace(t_block, labels=torch.from_numpy(labels)),
        t_losses.LOSSES[loss_name], t_losses.l2(1e-3), TConfig(**kw),
        backend=TSimBackend(q, TCluster()) if metered else None))
    return ref, port


@pytest.mark.parametrize("loss_name", ["squared", "logistic"])
def test_multi_output_matches_reference_vmap(loss_name):
    k = 3
    y = _multi_labels(k)
    ref, port = _multi(y, loss_name, dict(inner_steps=16))
    assert port.w.shape == (DATA["dim"], k) and port.w.dtype == torch.float32
    _assert_runs_agree(ref, port)
    # Each column is the port's own scalar run on that column, bit for bit.
    for j in range(k):
        _, col = _multi(np.ascontiguousarray(y[:, j]), loss_name, dict(inner_steps=16),
                        metered=False)
        assert torch.equal(port.w[:, j].contiguous(), col.w)


def test_multi_output_k1_bitwise_equals_scalar_path():
    y = _data()[1].labels.numpy()
    cfg = TConfig(eta=0.2, inner_steps=16, outer_iters=2, seed=2)
    block = _blocks(2)[1]
    wide = dataclasses.replace(block, labels=torch.from_numpy(y[:, None].copy()))
    res = t_rules.run_with_rule(t_rules.SVRGRule(),
                                t_rules.make_context(wide, t_losses.logistic, t_losses.l2(1e-3),
                                                     cfg))
    ref = t_rules.run_with_rule(t_rules.SVRGRule(),
                                t_rules.make_context(block, t_losses.logistic, t_losses.l2(1e-3),
                                                     cfg))
    assert res.w.ndim == 1  # [N, 1] labels are squeezed onto the 1-D path
    assert torch.equal(res.w, ref.w)
    assert res.objectives().tolist() == ref.objectives().tolist()


@pytest.mark.parametrize("q", [2, 4])
def test_multi_output_meter_scales_by_k(q):
    k = 3
    ref, wide = _multi(_multi_labels(k), "squared", dict(inner_steps=8), q=q)
    _, scalar = _multi(_data()[1].labels.numpy(), "squared", dict(inner_steps=8), q=q,
                       use_kernels=True)
    assert wide.meter.state_dict() == ref.meter.state_dict()
    assert wide.meter.total_scalars == k * scalar.meter.total_scalars


def test_multi_output_rejects_kernels_lazy_and_other_rules():
    block = dataclasses.replace(_blocks(2)[1], labels=torch.from_numpy(_multi_labels(2)))
    ctx = t_rules.make_context(block, t_losses.logistic, t_losses.l2(1e-3),
                               TConfig(eta=0.2, inner_steps=4, outer_iters=1))
    assert ctx.num_outputs == 2
    for rule in (t_rules.SVRGRule(), t_rules.SVRGRule(use_kernels=False, lazy_updates="exact"),
                 t_rules.SAGARule(use_kernels=False), t_rules.BCDRule(use_kernels=False)):
        with pytest.raises(ValueError, match="multi-output"):
            t_rules.run_with_rule(rule, ctx)


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fd_saga", "fd_bcd"])
@pytest.mark.parametrize("reg", list(REGS))
def test_rule_kernel_runs_bitwise_and_near_plain_on_card(cuda_device, name, reg):
    q, outers = 4, 3
    cfg = _rule_cfg(name, q, TConfig)
    lam, lam2 = REGS[reg]
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        ctx = t_rules.make_context(_blocks(q)[1].to(cuda_device), t_losses.logistic,
                                   t_losses.Regularizer(reg, lam, lam2), cfg,
                                   backend=TSimBackend(q, TCluster()))
        runs.append(t_rules.run_with_rule(t_rules.RULES[name](), ctx))
        m, snaps = cfg.inner_steps * outers, outers + 1
        if name == "fd_saga":
            want = dict(sparse_margin=snaps + m, logistic_grad=snaps, block_scatter=snaps,
                        prox_update=q * m, fused_update=q * m)
        else:
            want = dict(sparse_margin=snaps + m, logistic_grad=snaps + m,
                        block_scatter=snaps + m)
        assert {k: v for k, v in ops.launch_counts().items() if v} == want
    assert torch.equal(runs[0].w, runs[1].w)
    assert runs[0].objectives().tolist() == runs[1].objectives().tolist()
    plain = _port_rule(name, q, reg, False, cuda_device)
    np.testing.assert_allclose(runs[0].objectives(), plain.objectives(), rtol=RUN_RTOL)
    w_err = float(torch.max(torch.abs(runs[0].w - plain.w)))
    assert w_err <= RUN_W_RTOL * float(torch.max(torch.abs(plain.w)))
    assert runs[0].meter.state_dict() == _port_rule(name, q, reg, True).meter.state_dict()


@pytest.mark.cuda
def test_multi_output_on_card_matches_cpu(cuda_device):
    y = _multi_labels(3)
    cfg = TConfig(eta=0.2, inner_steps=16, outer_iters=3, seed=2)

    def run(device):
        block = dataclasses.replace(_blocks(2)[1], labels=torch.from_numpy(y)).to(device)
        return t_rules.run_with_rule(
            t_rules.SVRGRule(use_kernels=False),
            t_rules.make_context(block, t_losses.logistic, t_losses.l2(1e-3), cfg))

    card, cpu = run(cuda_device), run("cpu")
    assert card.w.is_cuda and card.w.shape == cpu.w.shape
    np.testing.assert_allclose(card.objectives(), cpu.objectives(), rtol=RUN_RTOL)
    np.testing.assert_allclose(card.w.cpu().numpy(), cpu.w.numpy(), rtol=0, atol=W_ATOL)
