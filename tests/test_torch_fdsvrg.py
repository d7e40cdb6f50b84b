"""The port's FD-SVRG main path held against the reference drivers, on the CPU.

Each case runs the reference ``run_fdsvrg`` / ``run_serial_svrg`` and the
port's counterpart (``device="cpu"``) on the same generated bytes, for
q in {1, 2, 4, 8}, the four regularizers, Options I/II and u in {1, 4},
through the port's kernel path (``use_kernels=True``: the plain versions
on the CPU) and its plain path.

Exact: every meter field (scalars, rounds, per-kind counts, the event
log) and the history's ``comm_scalars``, ``comm_rounds`` and
``modeled_time_s``.  Stated tolerances after 3 outers: objectives and
grad norms rtol 1e-5, ``w`` atol 1e-5 (torch and XLA round the margin
sums and the sigmoid differently).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from repro.configs.fdsvrg_linear import CONFIGS as R_CONFIGS
from repro.core import losses as r_losses
from repro.core.fdsvrg import SVRGConfig as RConfig
from repro.core.fdsvrg import run_fdsvrg as r_run_fdsvrg
from repro.core.fdsvrg import run_serial_svrg as r_run_serial
from repro.core.partition import balanced as r_balanced
from repro.data import datasets as r_datasets
from repro.data.synthetic import make_sparse_classification as r_make

from repro_torch.configs.fdsvrg_linear import CONFIGS as T_CONFIGS
from repro_torch.core import driver as t_driver
from repro_torch.core import losses as t_losses
from repro_torch.core.fdsvrg import SVRGConfig as TConfig
from repro_torch.core.fdsvrg import full_gradient, objective
from repro_torch.core.fdsvrg import run_fdsvrg as t_run_fdsvrg
from repro_torch.core.fdsvrg import run_serial_svrg as t_run_serial
from repro_torch.core.partition import balanced as t_balanced
from repro_torch.data import datasets as t_datasets
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.dist import FaultError, LocalBackend
from repro_torch.kernels import ops

OBJ_RTOL = 1e-5
W_ATOL = 1e-5
DATA = dict(dim=4096, num_instances=256, nnz_per_instance=16, seed=0)
REGS = {
    "l2": (1e-3, 0.0),
    "l1": (1e-3, 0.0),
    "elastic_net": (1e-3, 1e-2),
    "none": (0.0, 0.0),
}
QS = [1, 2, 4, 8]
OPTION_U = [("I", 1), ("II", 4), ("II", 1), ("I", 4)]
# Every (q, reg) pair, each (option, u) four times, both port paths.
MATRIX = [
    (q, reg, *OPTION_U[(i + j) % 4], use_kernels)
    for (i, q), (j, reg) in itertools.product(enumerate(QS), enumerate(REGS))
    for use_kernels in (True, False)
]


@functools.lru_cache(maxsize=None)
def _data():
    return r_make(**DATA), t_make(**DATA)


def _cfgs(option, u, m=48, outers=3, seed=5, eta=0.2):
    kw = dict(eta=eta, inner_steps=m, outer_iters=outers, batch_size=u, option=option,
              seed=seed)
    return RConfig(**kw), TConfig(**kw)


@functools.lru_cache(maxsize=None)
def _reference_fd(q, reg, option, u):
    r_data, _ = _data()
    lam, lam2 = REGS[reg]
    rcfg, _ = _cfgs(option, u)
    return r_run_fdsvrg(r_data, r_balanced(r_data.dim, q), r_losses.logistic,
                        r_losses.Regularizer(reg, lam, lam2), rcfg)


def _run_errors(ref, port) -> dict:
    """Worst objective / grad-norm relative error and worst |w| error."""
    obj, r_obj = port.objectives(), ref.objectives()
    g = np.array([h.grad_norm for h in port.history])
    r_g = np.array([h.grad_norm for h in ref.history])
    return {
        "objective_rel": float(np.max(np.abs(obj - r_obj) / np.abs(r_obj))),
        "grad_norm_rel": float(np.max(np.abs(g - r_g) / np.abs(r_g))),
        "w_abs": float(np.max(np.abs(port.w.numpy() - np.asarray(ref.w)))),
    }


def _assert_runs_agree(ref, port, metered=True):
    err = _run_errors(ref, port)
    assert err["objective_rel"] <= OBJ_RTOL and err["grad_norm_rel"] <= OBJ_RTOL, err
    assert err["w_abs"] <= W_ATOL, err
    assert port.w.dtype == torch.float32
    for field in ("outer", "comm_scalars", "comm_rounds", "modeled_time_s"):
        assert [getattr(h, field) for h in port.history] == \
            [getattr(h, field) for h in ref.history], field
    assert port.meter.state_dict() == ref.meter.state_dict()
    if metered:
        assert port.meter.total_scalars > 0


def _port_fd(q, reg, option, u, use_kernels):
    _, t_data = _data()
    lam, lam2 = REGS[reg]
    _, tcfg = _cfgs(option, u)
    return t_run_fdsvrg(t_data, t_balanced(t_data.dim, q), t_losses.logistic,
                        t_losses.Regularizer(reg, lam, lam2), tcfg,
                        use_kernels=use_kernels, device="cpu")


@pytest.mark.parametrize("q,reg,option,u,use_kernels", MATRIX)
def test_fdsvrg_matches_reference(q, reg, option, u, use_kernels):
    ref = _reference_fd(q, reg, option, u)
    _assert_runs_agree(ref, _port_fd(q, reg, option, u, use_kernels), metered=q > 1)


@pytest.mark.parametrize("reg", list(REGS))
def test_serial_svrg_matches_reference(reg):
    r_data, t_data = _data()
    lam, lam2 = REGS[reg]
    rcfg, tcfg = _cfgs("II", 2)
    ref = r_run_serial(r_data, r_losses.logistic, r_losses.Regularizer(reg, lam, lam2), rcfg)
    port = t_run_serial(t_data, t_losses.logistic, t_losses.Regularizer(reg, lam, lam2), tcfg,
                        device="cpu")
    _assert_runs_agree(ref, port, metered=False)
    assert port.meter.total_scalars == 0


@pytest.mark.parametrize("reg", list(REGS))
def test_port_fd_equals_port_serial(reg):
    """Within the port: q = 8 FD-SVRG follows serial SVRG (tree-order sums)."""
    _, t_data = _data()
    lam, lam2 = REGS[reg]
    _, tcfg = _cfgs("I", 1)
    r = t_losses.Regularizer(reg, lam, lam2)
    serial = t_run_serial(t_data, t_losses.logistic, r, tcfg, device="cpu")
    fd = t_run_fdsvrg(t_data, t_balanced(t_data.dim, 8), t_losses.logistic, r, tcfg,
                      device="cpu")
    np.testing.assert_allclose(fd.w.numpy(), serial.w.numpy(), rtol=0, atol=W_ATOL)
    np.testing.assert_allclose(fd.objectives(), serial.objectives(), rtol=OBJ_RTOL)


def test_news20_slice_end_to_end_matches_reference():
    """The whole slice on the fdsvrg-news20 preset (container-scale data):
    preset -> data -> BlockCSR -> run_fdsvrg, against the reference."""
    r_pre, t_pre = R_CONFIGS["fdsvrg-news20"], T_CONFIGS["fdsvrg-news20"]
    r_data, t_data = r_datasets.load(r_pre.dataset), t_datasets.load(t_pre.dataset)
    kw = dict(eta=r_pre.eta, inner_steps=200, outer_iters=2, batch_size=r_pre.batch_size)
    ref = r_run_fdsvrg(r_data, r_balanced(r_data.dim, r_pre.workers),
                       r_losses.LOSSES[r_pre.loss], r_pre.regularizer(), RConfig(**kw),
                       use_kernels=True)
    ops.reset_launch_counts()
    port = t_run_fdsvrg(t_data, t_balanced(t_data.dim, t_pre.workers),
                        t_losses.LOSSES[t_pre.loss], t_pre.regularizer(), TConfig(**kw),
                        device="cpu")
    _assert_runs_agree(ref, port)
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    assert port.history[-1].objective < port.history[0].objective
    per_outer = 2 * 8 * t_data.num_instances + 200 * 2 * 8
    assert port.meter.total_scalars == 2 * per_outer


def test_warm_start_and_prebuilt_blocks_match_reference():
    r_data, t_data = _data()
    w0 = (np.random.default_rng(3).normal(size=r_data.dim) * 0.01).astype(np.float32)
    rcfg, tcfg = _cfgs("I", 1, outers=2)
    ref = r_run_fdsvrg(r_data, r_balanced(r_data.dim, 4), r_losses.logistic,
                       r_losses.l2(1e-3), rcfg, init_w=w0)
    part = t_balanced(t_data.dim, 4)
    backend = LocalBackend(4)
    port = t_run_fdsvrg(None, part, t_losses.logistic, t_losses.l2(1e-3), tcfg,
                        backend=backend, block_data=BlockCSR.from_padded(t_data, part),
                        init_w=w0, device="cpu")
    _assert_runs_agree(ref, port)
    assert port.meter is backend.meter


def test_objective_and_full_gradient_match_global_layout():
    r_data, t_data = _data()
    w = torch.from_numpy((np.random.default_rng(4).normal(size=t_data.dim) * 0.1)
                         .astype(np.float32))
    z, s0 = full_gradient(t_data, w, t_losses.logistic)
    bd = BlockCSR.from_padded(t_data, t_balanced(t_data.dim, 1))
    from repro_torch.core.fdsvrg import _full_grad_blocks

    z1, s1 = _full_grad_blocks(bd, w, t_losses.logistic, use_kernels=False)
    assert torch.equal(z, z1) and torch.equal(s0, s1)
    obj = objective(t_data, w, t_losses.logistic, t_losses.l2(1e-3))
    assert obj == pytest.approx(
        t_driver.objective_from_margins(s0, t_data.labels, w, t_losses.logistic,
                                        t_losses.l2(1e-3)))


def test_unported_options_raise():
    _, t_data = _data()
    _, tcfg = _cfgs("I", 1, outers=1)
    with pytest.raises(ValueError, match="lazy_updates must be None, 'exact', or 'proba'"):
        t_run_fdsvrg(t_data, t_balanced(t_data.dim, 2), t_losses.logistic, t_losses.l2(1e-3),
                     tcfg, lazy_updates="bogus", device="cpu")
    bd = BlockCSR.from_padded(t_data, t_balanced(t_data.dim, 1))
    import dataclasses

    multi = dataclasses.replace(bd, labels=torch.stack([bd.labels, bd.labels], 1))
    # Multi-output labels run the dense epoch only: the lazy steps refuse
    # them (the kernel route runs them as one scalar epoch a column).
    with pytest.raises(ValueError, match="multi-output"):
        t_run_serial(None, t_losses.logistic, t_losses.l2(1e-3), tcfg, block_data=multi,
                     lazy_updates="exact", device="cpu")
    with pytest.raises(ValueError, match="q=1 layout"):
        t_run_serial(None, t_losses.logistic, t_losses.l2(1e-3), tcfg,
                     block_data=BlockCSR.from_padded(t_data, t_balanced(t_data.dim, 2)),
                     device="cpu")


def test_harness_retries_a_faulted_epoch_from_the_snapshot():
    """Epoch-abort-to-snapshot: a fault in one epoch is retried from the
    same snapshot, the abort is metered, and the trajectory is unchanged."""
    calls = []

    def snapshot(w):
        return w * 0.0, w + 1.0

    def epoch(t, rng, w, z, s0, eta_scale=1.0):
        calls.append((t, eta_scale))
        if len(calls) == 2:
            raise FaultError("injected")
        return w + 1.0

    def evaluate(w, z, s0):
        return float(w.sum()), 0.0

    backend = LocalBackend(2)
    res = t_driver.run_outer_loop(
        outer_iters=3, seed=0, init_w=torch.zeros(2), snapshot=snapshot, epoch=epoch,
        evaluate=evaluate, backend=backend,
        recovery=t_driver.RecoveryPolicy(on_abort=lambda b: b.p2p(7, "abort")),
    )
    assert [c[0] for c in calls] == [0, 1, 1, 2]
    assert res.objectives().tolist() == [2.0, 4.0, 6.0]
    assert backend.meter.by_kind["abort"] == 7
    with pytest.raises(FaultError):
        calls.clear()
        t_driver.run_outer_loop(outer_iters=2, seed=0, init_w=torch.zeros(2),
                                snapshot=snapshot, epoch=epoch, evaluate=evaluate)


def test_divergence_guard_backs_off_eta():
    seen = []

    def epoch(t, rng, w, z, s0, eta_scale=1.0):
        seen.append(eta_scale)
        return w + (float("nan") if eta_scale == 1.0 and t == 1 else 1.0)

    res = t_driver.run_outer_loop(
        outer_iters=2, seed=0, init_w=torch.zeros(1), snapshot=lambda w: (w, w),
        epoch=epoch, evaluate=lambda w, z, s: (float(w.sum()), 0.0),
        recovery=t_driver.RecoveryPolicy(),
    )
    assert seen == [1.0, 1.0, 0.5]
    assert np.isfinite(res.objectives()).all()


if __name__ == "__main__":
    # The worst case over the driver matrix, against the stated tolerances:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fdsvrg.py
    worst: dict = {}
    for case in MATRIX:
        for key, val in _run_errors(_reference_fd(*case[:4]), _port_fd(*case)).items():
            if val >= worst.get(key, (-1.0,))[0]:
                worst[key] = (val, case)
    print({"tolerance": {"objective_rel": OBJ_RTOL, "grad_norm_rel": OBJ_RTOL,
                         "w_abs": W_ATOL}, "worst": worst})
