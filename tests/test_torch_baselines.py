"""The port's baselines (``repro_torch.core.baselines``) held against the
reference's (``repro.core.baselines``), on the CPU.

DSVRG, SynSVRG, AsySVRG and PS-Lite SGD at q in {2, 4}, l2 and l1, through
the port's kernel route (``use_kernels=True``: the plain versions on the
CPU) and its plain path, on the same generated bytes.

Exact: the sample ids (and the async delays) each epoch draws, every
meter field, the history's ``comm_scalars`` and ``comm_rounds``, and the
§4.5 closed forms; ``modeled_time_s`` at rtol 1e-12.  Stated tolerances
after 3 outers: objectives and grad norms rtol 1e-5, ``w`` atol 1e-5 (the
tolerances of ``tests/test_torch_fdsvrg.py``: torch and XLA round the
margin sums and the sigmoid differently; the async kernel route also
folds ``z + grad g_smooth(w_stale)`` first and scales before the scatter).
The ``cuda``-marked twins hold two kernel runs bitwise equal on the card
and the kernel route against the plain path within ``RUN_RTOL`` /
``RUN_W_RTOL``, with exact launch counts.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_baselines.py

prints the worst errors over the matrix.
"""

import dataclasses
import functools
import itertools
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core import baselines as r_baselines
from repro.core import losses as r_losses
from repro.core.fdsvrg import SVRGConfig as RConfig
from repro.data.synthetic import make_sparse_classification as r_make
from repro.dist import ClusterModel as RCluster

from repro_torch.core import baselines as t_baselines
from repro_torch.core import losses as t_losses
from repro_torch.core.driver import optimality_norm
from repro_torch.core.fdsvrg import SVRGConfig as TConfig
from repro_torch.core.fdsvrg import full_gradient
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.dist import COSTS
from repro_torch.dist import ClusterModel as TCluster
from repro_torch.kernels import ops

OBJ_RTOL = 1e-5
W_ATOL = 1e-5
RUN_RTOL, RUN_W_RTOL = 1e-5, 1e-3
# n divisible by q so the paper's M conventions are whole numbers.
DATA = dict(dim=512, num_instances=48, nnz_per_instance=8, seed=2)
REGS = {"l2": (1e-3, 0.0), "l1": (1e-3, 0.0)}
METHODS = {
    # method: (runner, epoch hook, the hook's sample (and delay) argument
    # positions in the reference and in the port)
    "dsvrg": ("run_dsvrg", "_inner_epoch", (6,), (4,)),
    "synsvrg": ("run_syn_svrg", "_inner_epoch", (6,), (4,)),
    "asysvrg": ("run_asy_svrg", "_async_epoch", (6, 7), (4, 5)),
    "pslite_sgd": ("run_pslite_sgd", "_async_epoch", (6, 7), (4, 5)),
}
QS = [2, 4]
MATRIX = list(itertools.product(METHODS, QS, REGS, [True, False]))


@functools.lru_cache(maxsize=None)
def _data():
    return r_make(**DATA), t_make(**DATA)


def _steps(method, q):
    n = DATA["num_instances"]
    return n // q if method in ("dsvrg", "synsvrg") else n


def _cfg(method, q, cls, outers=3, u=1):
    return cls(eta=0.1, inner_steps=_steps(method, q), outer_iters=outers, batch_size=u,
               seed=5)


def _recorded(module, hook, positions, call):
    """``call()``'s result and each epoch's sample (and delay) arrays, read
    from the arguments of ``module.hook``."""
    seen = []
    original = getattr(module, hook)

    def spy(*args, **kwargs):
        seen.append(tuple(np.asarray(args[p]) for p in positions))
        return original(*args, **kwargs)

    with mock.patch.object(module, hook, spy):
        return call(), seen


@functools.lru_cache(maxsize=None)
def _reference(method, q, reg):
    r_data, _ = _data()
    name, hook, positions, _ = METHODS[method]
    lam, lam2 = REGS[reg]
    return _recorded(r_baselines, hook, positions, lambda: getattr(r_baselines, name)(
        r_data, q, r_losses.logistic, r_losses.Regularizer(reg, lam, lam2),
        _cfg(method, q, RConfig), RCluster()))


@functools.lru_cache(maxsize=None)
def _port(method, q, reg, use_kernels):
    _, t_data = _data()
    name, hook, _, positions = METHODS[method]
    lam, lam2 = REGS[reg]
    return _recorded(t_baselines, hook, positions, lambda: getattr(t_baselines, name)(
        t_data, q, t_losses.logistic, t_losses.Regularizer(reg, lam, lam2),
        _cfg(method, q, TConfig), TCluster(), use_kernels=use_kernels, device="cpu"))


def _run_errors(ref, port) -> dict:
    """Worst objective / grad-norm relative error and worst |w| error."""
    obj, r_obj = port.objectives(), ref.objectives()
    g = np.array([h.grad_norm for h in port.history])
    r_g = np.array([h.grad_norm for h in ref.history])
    return {
        "objective_rel": float(np.max(np.abs(obj - r_obj) / np.abs(r_obj))),
        "grad_norm_rel": float(np.max(np.abs(g - r_g) / np.abs(r_g))),
        "w_abs": float(np.max(np.abs(port.w.cpu().numpy() - np.asarray(ref.w)))),
    }


@pytest.mark.parametrize("method,q,reg,use_kernels", MATRIX)
def test_baseline_matches_reference(method, q, reg, use_kernels):
    ref, ref_samples = _reference(method, q, reg)
    port, port_samples = _port(method, q, reg, use_kernels)
    # The sample stream: the same ids (and delays), epoch by epoch.
    assert len(port_samples) == len(ref_samples) == 3
    for got, want in zip(port_samples, ref_samples):
        for g, w in zip(got, want, strict=True):
            assert g.dtype == np.int32 and np.array_equal(g, w)
    # The meter: every field, record by record, and the closed form.
    assert port.meter.state_dict() == ref.meter.state_dict()
    for field in ("outer", "comm_scalars", "comm_rounds"):
        assert [getattr(h, field) for h in port.history] == \
            [getattr(h, field) for h in ref.history], field
    np.testing.assert_allclose([h.modeled_time_s for h in port.history],
                               [h.modeled_time_s for h in ref.history], rtol=1e-12)
    n, d, nnz = DATA["num_instances"], DATA["dim"], _data()[1].nnz_max
    t1, c1 = COSTS.outer_cost(method, n=n, d=d, nnz=nnz, q=q, inner_steps=_steps(method, q))
    assert [h.comm_scalars for h in port.history] == [c1 * (t + 1) for t in range(3)]
    np.testing.assert_allclose(port.history[-1].modeled_time_s, 3 * t1, rtol=1e-12)
    # The numbers, against the reference and (kernel route) the plain path.
    err = _run_errors(ref, port)
    assert err["objective_rel"] <= OBJ_RTOL and err["grad_norm_rel"] <= OBJ_RTOL, err
    assert err["w_abs"] <= W_ATOL, err
    assert port.w.dtype == torch.float32 and port.w.shape == (d,)
    if use_kernels:
        plain, _ = _port(method, q, reg, False)
        np.testing.assert_allclose(port.objectives(), plain.objectives(), rtol=OBJ_RTOL)
        np.testing.assert_allclose(port.w.numpy(), plain.w.numpy(), rtol=0, atol=W_ATOL)


def test_instance_shards_equal_reference():
    for n, q in [(48, 2), (48, 4), (50, 4), (7, 8), (19_954, 8), (1, 1)]:
        assert t_baselines.instance_shards(n, q) == r_baselines.instance_shards(n, q)


@pytest.mark.parametrize("method", ["pslite_sgd", "asysvrg"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_async_grad_norm_is_post_epoch_residual(method, use_kernels):
    """The async pair reports the same-iterate residual, PS-Lite included
    (its snapshot is reporting-only)."""
    _, t_data = _data()
    reg = t_losses.l2(1e-3)
    cfg = TConfig(eta=0.1, inner_steps=16, outer_iters=2, seed=13)
    run = getattr(t_baselines, METHODS[method][0])
    res = run(t_data, 4, t_losses.logistic, reg, cfg, use_kernels=use_kernels, device="cpu")
    gd, _ = full_gradient(t_data, res.w, t_losses.logistic)
    want = optimality_norm(gd, res.w, reg, cfg.eta)
    np.testing.assert_allclose(res.history[-1].grad_norm, want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("method", list(METHODS))
def test_float64_kept_on_plain_path_and_refused_by_kernels(method):
    _, t_data = _data()
    wide = dataclasses.replace(t_data, values=t_data.values.double(),
                               labels=t_data.labels.double())
    run = getattr(t_baselines, METHODS[method][0])
    cfg = _cfg(method, 2, TConfig, outers=1)
    res = run(wide, 2, t_losses.logistic, t_losses.l1(1e-3), cfg, use_kernels=False,
              device="cpu")
    assert res.w.dtype == torch.float64 and np.isfinite(res.final_objective())
    with pytest.raises(ValueError, match="float32"):
        run(wide, 2, t_losses.logistic, t_losses.l1(1e-3), cfg, device="cpu")


@pytest.mark.parametrize("method", list(METHODS))
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(method, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t_data = _data()
    run = getattr(t_baselines, METHODS[method][0])
    cfg = _cfg(method, 2, TConfig, outers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(t_data, 2, t_losses.logistic, t_losses.l2(1e-3), cfg)
    ops.reset_launch_counts()
    run(t_data, 2, t_losses.logistic, t_losses.l2(1e-3), cfg, device="cpu")
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


def _launches(method, q, outers=3, u=1):
    """Each kernel's launches in a kernel-route run: one margins, one
    coefficient and one scatter launch a snapshot; a step's margins, its
    coefficients (none for PS-Lite) and its update."""
    m = _steps(method, q)
    snapshots = outers + 1
    return dict(sparse_margin=snapshots + outers * m,
                logistic_grad=snapshots + (0 if method == "pslite_sgd" else outers * m),
                block_scatter=snapshots, prox_update=outers * m)


@pytest.mark.cuda
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("reg", list(REGS))
def test_kernel_runs_bitwise_and_near_plain_on_card(cuda_device, method, reg):
    _, t_data = _data()
    lam, lam2 = REGS[reg]
    r = t_losses.Regularizer(reg, lam, lam2)
    run = getattr(t_baselines, METHODS[method][0])
    cfg = _cfg(method, 4, TConfig)
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        runs.append(run(t_data, 4, t_losses.logistic, r, cfg))
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == _launches(method, 4)
    assert runs[0].w.is_cuda
    assert torch.equal(runs[0].w, runs[1].w)
    assert runs[0].objectives().tolist() == runs[1].objectives().tolist()
    plain = run(t_data, 4, t_losses.logistic, r, cfg, use_kernels=False)
    np.testing.assert_allclose(runs[0].objectives(), plain.objectives(), rtol=RUN_RTOL)
    w_err = float(torch.max(torch.abs(runs[0].w - plain.w)))
    assert w_err <= RUN_W_RTOL * float(torch.max(torch.abs(plain.w)))
    cpu, _ = _port(method, 4, reg, True)
    np.testing.assert_allclose(runs[0].objectives(), cpu.objectives(), rtol=OBJ_RTOL)


if __name__ == "__main__":
    worst: dict = {}
    for method, q, reg, use_kernels in MATRIX:
        err = _run_errors(_reference(method, q, reg)[0], _port(method, q, reg, use_kernels)[0])
        for key, val in err.items():
            worst[(method, key)] = max(val, worst.get((method, key), 0.0))
        if use_kernels:  # the kernel route against the plain path
            plain, port = _port(method, q, reg, False)[0], _port(method, q, reg, True)[0]
            gap = {"objective_rel": float(np.max(np.abs(port.objectives() - plain.objectives())
                                                 / np.abs(plain.objectives()))),
                   "w_abs": float(np.max(np.abs(port.w.numpy() - plain.w.numpy())))}
            for key, val in gap.items():
                worst[(method, "kernel vs plain " + key)] = max(
                    val, worst.get((method, "kernel vs plain " + key), 0.0))
    print({"tolerances": {"objective_rel": OBJ_RTOL, "grad_norm_rel": OBJ_RTOL,
                          "w_abs": W_ATOL}})
    for key, val in sorted(worst.items()):
        print(key, f"{val:.3e}")
