"""The port's fault injection (``repro_torch.dist.faults``), checkpoints
(``repro_torch.checkpoint.ckpt``) and the harness's checkpoint/resume
(``CheckpointPolicy`` in ``repro_torch.core.driver``), held against the
reference's, on the CPU.

Tolerances: the fault layer is host code and held exactly against the
reference — for the same plan and call sequence the same events, the
same meter (every field and event) and the same modeled time.  Whole
runs under faults hold the meter and the modeled time exactly against
the reference's, and the objectives within ``OBJ_RTOL`` (the port's
PyTorch against the reference's XLA); within the port a run whose faults
only retry, and a run recovered from a crash, are bit for bit the
fault-free run, and a resumed run bit for bit the uninterrupted one
(iterates, objectives, meter, modeled time).  The checkpoint refusals
follow the reference's ``supports_checkpoint`` flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as r_losses
from repro.core.driver import RecoveryPolicy as RRecoveryPolicy
from repro.core.fdsvrg import SVRGConfig as RConfig
from repro.core.fdsvrg import run_fdsvrg as r_run_fdsvrg
from repro.core.partition import balanced as r_balanced
from repro.data.synthetic import make_sparse_classification as r_make
from repro.dist import faults as r_faults
from repro.dist import SimBackend as RSimBackend
from repro.optim import update_rules as r_rules

from repro_torch.checkpoint import ckpt
from repro_torch.core import losses as t_losses
from repro_torch.core.driver import CheckpointPolicy, RecoveryPolicy
from repro_torch.core.fdsvrg import SVRGConfig as TConfig
from repro_torch.core.fdsvrg import fdsvrg_worker_simulation, run_fdsvrg, run_serial_svrg
from repro_torch.core.partition import balanced as t_balanced
from repro_torch.data.block_csr import BlockCSR as TBlockCSR
from repro_torch.data.synthetic import make_sparse_classification as t_make
from repro_torch.dist import faults as t_faults
from repro_torch.dist import SimBackend as TSimBackend
from repro_torch.optim import update_rules as t_rules

OBJ_RTOL = 1e-5
Q = 4
DATA = dict(dim=256, num_instances=48, nnz_per_instance=8, seed=2)
CFG = dict(eta=0.3, inner_steps=8, outer_iters=3, seed=13, batch_size=2)
PLANS = {
    "drops": dict(seed=0, drop_prob=0.3),
    "stragglers": dict(seed=1, straggler_prob=0.5, straggler_delay_s=0.2),
    "drops_and_stragglers": dict(seed=2, drop_prob=0.2, straggler_prob=0.3,
                                 straggler_delay_s=0.15),
}
RETRY = dict(max_retries=8, timeout_s=0.1)


@pytest.fixture(scope="module")
def data():
    return r_make(**DATA), t_make(**DATA)


def _faulty(module, backend_cls, plan, retry=RETRY):
    return module.FaultyBackend(backend_cls(Q), module.FaultPlan(**plan),
                                module.RetryPolicy(**retry))


def _assert_identical_runs(res, ref):
    assert torch.equal(res.w, ref.w)
    for a, b in zip(res.history, ref.history, strict=True):
        assert (a.outer, a.objective, a.grad_norm) == (b.outer, b.objective, b.grad_norm)
        assert (a.comm_scalars, a.comm_rounds, a.modeled_time_s) == \
            (b.comm_scalars, b.comm_rounds, b.modeled_time_s)
    assert res.meter.state_dict() == ref.meter.state_dict()


# ---------------------------------------------------------------------------
# the wrapper, against the reference's
# ---------------------------------------------------------------------------


def test_plan_and_policy_validate_like_reference():
    for kw in (dict(drop_prob=1.0), dict(corrupt_prob=-0.1), dict(straggler_delay_s=-1.0)):
        with pytest.raises(ValueError) as ref_err:
            r_faults.FaultPlan(**kw)
        with pytest.raises(ValueError) as port_err:
            t_faults.FaultPlan(**kw)
        assert str(port_err.value) == str(ref_err.value)
    assert t_faults.FaultPlan().is_noop
    assert t_faults.FaultPlan(crash_at_outer=1).crash_at_outer == (1,)
    for attempt, draw in ((0, 0.7), (2, 0.3), (5, 1.0)):
        assert t_faults.RetryPolicy(jitter=0.5).backoff_s(attempt, draw) == \
            r_faults.RetryPolicy(jitter=0.5).backoff_s(attempt, draw)
    for kw in (dict(max_retries=-1), dict(timeout_s=-0.1)):
        with pytest.raises(ValueError):
            t_faults.RetryPolicy(**kw)


@pytest.mark.parametrize("plan", [dict(seed=0, drop_prob=0.5),
                                  dict(seed=1, straggler_prob=0.6, straggler_delay_s=0.3),
                                  dict(seed=3, drop_prob=0.3, corrupt_prob=0.4)])
def test_same_plan_draws_the_same_faults_as_reference(plan):
    ref = _faulty(r_faults, RSimBackend, plan, dict(max_retries=12, timeout_s=0.1))
    port = _faulty(t_faults, TSimBackend, plan, dict(max_retries=12, timeout_s=0.1))
    for step in range(30):
        ref.meter_tree(payload=step % 5 + 1, steps=2)
        port.meter_tree(payload=step % 5 + 1, steps=2)
        ref.p2p(7 * step, "p2p", rounds=1)
        port.p2p(7 * step, "p2p", rounds=1)
        parts = np.arange(4 * Q, dtype=np.float32).reshape(Q, 4) + step
        r_out = np.asarray(ref.all_reduce([jnp.asarray(p) for p in parts]))
        t_out = port.all_reduce([torch.from_numpy(p) for p in parts]).numpy()
        assert np.array_equal(np.isnan(r_out), np.isnan(t_out))
        assert np.array_equal(r_out[~np.isnan(r_out)], t_out[~np.isnan(t_out)])
    assert port.meter.state_dict() == ref.meter.state_dict()
    assert port.modeled_time_s == ref.modeled_time_s
    assert port.meter.total_scalars == \
        sum(v for k, v in port.meter.by_kind.items() if k != "retry") + \
        port.meter.by_kind.get("retry", 0)


def test_exhaustion_crash_arming_and_q1_immunity_match_reference():
    for module, backend in ((r_faults, RSimBackend), (t_faults, TSimBackend)):
        b = module.FaultyBackend(backend(Q), module.FaultPlan(seed=0, drop_prob=0.99),
                                 module.RetryPolicy(max_retries=0))
        with pytest.raises(module.RetriesExhaustedError, match="consecutive"):
            b.meter_tree(payload=3)
        b = module.FaultyBackend(backend(Q), module.FaultPlan(crash_at_outer=(1,)))
        b.begin_outer(0)
        b.meter_tree(payload=2)
        b.begin_outer(1)
        with pytest.raises(module.WorkerCrashError, match="outer iteration 1"):
            b.meter_tree(payload=2)
        b.begin_outer(1)  # the restarted attempt does not crash again
        b.meter_tree(payload=2)
        one = module.FaultyBackend(backend(1), module.FaultPlan(seed=0, drop_prob=0.9),
                                   module.RetryPolicy(max_retries=0))
        one.meter_tree(payload=5)
        assert one.meter.total_scalars == 0
    assert issubclass(t_faults.WorkerCrashError, t_faults.FaultError)


# ---------------------------------------------------------------------------
# whole runs under faults
# ---------------------------------------------------------------------------


def _runs(data, plan, use_kernels, recovery=False):
    r_data, t_data = data
    r_b = _faulty(r_faults, RSimBackend, plan)
    t_b = _faulty(t_faults, TSimBackend, plan)
    ref = r_run_fdsvrg(r_data, r_balanced(r_data.dim, Q), r_losses.logistic,
                       r_losses.l2(1e-3), RConfig(**CFG), backend=r_b,
                       recovery=RRecoveryPolicy() if recovery else None)
    port = run_fdsvrg(t_data, t_balanced(t_data.dim, Q), t_losses.logistic,
                      t_losses.l2(1e-3), TConfig(**CFG), backend=t_b,
                      use_kernels=use_kernels, device="cpu",
                      recovery=RecoveryPolicy() if recovery else None)
    clean = run_fdsvrg(t_data, t_balanced(t_data.dim, Q), t_losses.logistic,
                       t_losses.l2(1e-3), TConfig(**CFG), backend=TSimBackend(Q),
                       use_kernels=use_kernels, device="cpu")
    return ref, port, clean


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("plan", list(PLANS))
def test_faulty_run_matches_reference_and_the_clean_run(data, plan, use_kernels):
    ref, port, clean = _runs(data, PLANS[plan], use_kernels)
    assert port.meter.state_dict() == ref.meter.state_dict()
    assert [h.modeled_time_s for h in port.history] == [h.modeled_time_s for h in ref.history]
    np.testing.assert_allclose(port.objectives(), ref.objectives(), rtol=OBJ_RTOL)
    # retries only: the trajectory is the clean run's bit for bit, and the
    # meter is the clean schedule plus the retransmissions, exactly
    assert torch.equal(port.w, clean.w)
    assert [(h.objective, h.grad_norm) for h in port.history] == \
        [(h.objective, h.grad_norm) for h in clean.history]
    retry = port.meter.by_kind.get("retry", 0)
    assert retry > 0
    assert port.meter.total_scalars == clean.meter.total_scalars + retry


@pytest.mark.parametrize("use_kernels", [True, False])
def test_crash_recovery_matches_reference_and_the_clean_run(data, use_kernels):
    plan = dict(seed=4, drop_prob=0.2, crash_at_outer=(1,))
    ref, port, clean = _runs(data, plan, use_kernels, recovery=True)
    assert port.meter.state_dict() == ref.meter.state_dict()
    np.testing.assert_allclose(port.objectives(), ref.objectives(), rtol=OBJ_RTOL)
    assert torch.equal(port.w, clean.w)
    assert port.objectives().tolist() == clean.objectives().tolist()
    kinds = port.meter.by_kind
    assert kinds["abort"] == 2 * Q * DATA["num_instances"]
    assert port.meter.total_scalars == \
        clean.meter.total_scalars + kinds["retry"] + kinds["abort"]
    with pytest.raises(t_faults.WorkerCrashError):
        run_fdsvrg(data[1], t_balanced(DATA["dim"], Q), t_losses.logistic, t_losses.l2(1e-3),
                   TConfig(**CFG), backend=_faulty(t_faults, TSimBackend, plan),
                   device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_worker_simulation_under_faults_matches_reference(data, use_kernels):
    """The executable spec sends every step's margins through
    ``all_reduce``: under the same plan the same retries, the same meter
    and modeled time as the reference, and the clean run's trajectory."""
    from repro.core.fdsvrg import fdsvrg_worker_simulation as r_sim

    r_data, t_data = data
    plan = PLANS["drops_and_stragglers"]
    ref = r_sim(r_data, r_balanced(r_data.dim, Q), r_losses.logistic, r_losses.l2(1e-3),
                RConfig(**CFG), backend=_faulty(r_faults, RSimBackend, plan))
    port, clean = (fdsvrg_worker_simulation(
        t_data, t_balanced(t_data.dim, Q), t_losses.logistic, t_losses.l2(1e-3),
        TConfig(**CFG), backend=b, use_kernels=use_kernels, device="cpu")
        for b in (_faulty(t_faults, TSimBackend, plan), TSimBackend(Q)))
    assert port.meter.state_dict() == ref.meter.state_dict()
    assert [h.modeled_time_s for h in port.history] == [h.modeled_time_s for h in ref.history]
    np.testing.assert_allclose(port.objectives(), ref.objectives(), rtol=OBJ_RTOL)
    assert torch.equal(port.w, clean.w)
    assert port.meter.by_kind["retry"] > 0


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------


def _run_driver(method, data, cfg, use_kernels, checkpoint=None, backend=None, recovery=None):
    t_data = data[1]
    common = dict(use_kernels=use_kernels, checkpoint=checkpoint, device="cpu")
    if method == "serial":
        return run_serial_svrg(t_data, t_losses.logistic, t_losses.l2(1e-3), cfg, **common)
    part = t_balanced(t_data.dim, Q)
    backend = backend or TSimBackend(Q)
    if method == "fdsvrg":
        return run_fdsvrg(t_data, part, t_losses.logistic, t_losses.l2(1e-3), cfg,
                          backend=backend, recovery=recovery, **common)
    return fdsvrg_worker_simulation(t_data, part, t_losses.logistic, t_losses.l2(1e-3), cfg,
                                    backend=backend, recovery=recovery, **common)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("method", ["serial", "fdsvrg", "fdsvrg_sim"])
def test_resume_is_bit_identical(tmp_path, data, method, use_kernels):
    full, half = TConfig(**{**CFG, "outer_iters": 4}), TConfig(**{**CFG, "outer_iters": 2})
    ref = _run_driver(method, data, full, use_kernels)
    ckdir = str(tmp_path / method)
    _run_driver(method, data, half, use_kernels,
                checkpoint=CheckpointPolicy(directory=ckdir, every=2))
    res = _run_driver(method, data, full, use_kernels,
                      checkpoint=CheckpointPolicy(directory=ckdir, every=2, resume=True))
    assert res.history[0].outer == 0
    _assert_identical_runs(res, ref)
    fresh = _run_driver(method, data, full, use_kernels, checkpoint=CheckpointPolicy(
        directory=str(tmp_path / "empty"), resume=True))
    _assert_identical_runs(fresh, ref)


def test_resume_after_a_faulty_run_replays_its_state(tmp_path, data):
    # A crash plan only: the checkpoint keeps the harness's state, not the
    # wrapper's fault stream, so a resumed run with drops would draw anew.
    plan = dict(crash_at_outer=(1,))

    def faulty(outers, checkpoint=None):
        return _run_driver("fdsvrg", data, TConfig(**{**CFG, "outer_iters": outers}), True,
                           checkpoint=checkpoint, recovery=RecoveryPolicy(),
                           backend=_faulty(t_faults, TSimBackend, plan))

    ref = faulty(4)
    ckdir = str(tmp_path / "faulty")
    faulty(2, CheckpointPolicy(directory=ckdir))
    res = faulty(4, CheckpointPolicy(directory=ckdir, resume=True))
    _assert_identical_runs(res, ref)
    assert res.meter.by_kind["abort"] == 2 * Q * DATA["num_instances"]


def test_checkpoint_refusals_follow_the_reference_flags(tmp_path, data):
    for name in ("svrg", "fd_saga", "fd_bcd"):
        assert t_rules.RULES[name].supports_checkpoint == \
            r_rules.RULES[name].supports_checkpoint
    ctx = t_rules.make_context(TBlockCSR.from_padded(data[1], t_balanced(DATA["dim"], 2)),
                               t_losses.logistic, t_losses.l2(1e-3), TConfig(**CFG))
    policy = CheckpointPolicy(directory=str(tmp_path / "x"))
    for rule in (t_rules.SAGARule(), t_rules.BCDRule()):
        with pytest.raises(ValueError, match="checkpoint/resume"):
            t_rules.run_with_rule(rule, ctx, checkpoint=policy)
    for kw in (dict(directory=""), dict(directory="d", every=0)):
        with pytest.raises(ValueError):
            CheckpointPolicy(**kw)


def test_ckpt_round_trip_and_validation(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32), "b": [torch.ones(2, 3),
             np.arange(4, dtype=np.int64)], "step": (torch.tensor(3, dtype=torch.int32),)}
    path = str(tmp_path / "c" / "state")
    ckpt.save(path, state, extra={"rng": {"state": 2**100 + 7}, "x": 0.1})
    back = ckpt.restore(path, state)
    assert torch.equal(back["w"], state["w"]) and torch.equal(back["b"][0], state["b"][0])
    assert np.array_equal(back["b"][1], state["b"][1]) and isinstance(back["step"], tuple)
    meta = ckpt.load_meta(path)
    assert meta["keys"] == ["['b'][0]", "['b'][1]", "['step'][0]", "['w']"]
    assert meta["extra"] == {"rng": {"state": 2**100 + 7}, "x": 0.1}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, {**state, "w": torch.zeros(5)})
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(path, {**state, "w": torch.zeros(6, dtype=torch.float64)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(path, {("v" if k == "w" else k): v for k, v in state.items()})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(path, {"w": torch.zeros(6)})


if __name__ == "__main__":
    d = (r_make(**DATA), t_make(**DATA))
    ref, port, clean = _runs(d, PLANS["drops_and_stragglers"], True)
    print("objective rel vs reference:",
          float(np.max(np.abs(port.objectives() - ref.objectives()) / ref.objectives())),
          "tolerance", OBJ_RTOL)
