"""The port's spans (``repro_torch.spans``): ``rt/*`` profiler ranges at each
layer boundary of the FD-SVRG path, nested solve > outer > epoch > step,
recorded only while a profiler records.

A CPU solve under a CPU ``torch.profiler`` yields one ``rt/solve``, K
``rt/outer``, K ``rt/epoch``, K + 1 ``rt/snapshot``, K ``rt/evaluate`` and
K·M ``rt/step``, each step inside an epoch inside an outer inside the
solve; the same solve with no profiler makes no profiler range and returns
the same bits.  Two spawned gloo ranks of ``fdsvrg_sharded`` see
the same spans plus ``rt/block_of``, ``rt/all_reduce`` and ``rt/all_gather``.
This file imports no JAX: the ranks import it.
"""

import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from repro_torch import api, spans
from repro_torch.core import losses
from repro_torch.data.synthetic import make_sparse_classification
from repro_torch.dist.launch import spawn_ranks

DATA = dict(dim=300, num_instances=64, nnz_per_instance=8, seed=1)
K, M, U, Q = 2, 5, 4, 2
SPAWN_S = 120.0


def _spec(method="fdsvrg", **kw):
    base = dict(method=method, data=make_sparse_classification(**DATA), outer_iters=K,
                inner_steps=M, batch_size=U, eta=0.1, reg=losses.l2(1e-3), seed=7,
                device="cpu")
    if method != "fdsvrg_sharded":
        base["q"] = Q
    return api.ExperimentSpec(**{**base, **kw})


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _spans(prof) -> dict[str, list[tuple[int, int, int]]]:
    """Each ``rt/*`` host range as (start_ns, end_ns, thread), by start."""
    out: dict[str, list] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("rt/") and ev.device_type() == DeviceType.CPU:
            out.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.start_thread_id()))
    return {k: sorted(v) for k, v in out.items()}


def _parents(span, outers) -> list:
    s, e, thread = span
    return [o for o in outers if o[2] == thread and o[0] <= s and e <= o[1]]


def _nested(got, inner: str, outer: str) -> bool:
    """Every ``inner`` span lies in exactly one ``outer`` span."""
    return all(len(_parents(x, got.get(outer, []))) == 1 for x in got.get(inner, []))


def _counts(got) -> dict[str, int]:
    return {k: len(v) for k, v in got.items()}


def _same_run(a, b) -> None:
    assert torch.equal(a.w, b.w)
    strip = [{**dataclasses.asdict(h), "wall_time_s": None} for h in a.history]
    assert strip == [{**dataclasses.asdict(h), "wall_time_s": None} for h in b.history]


VARIANTS = [pytest.param("exact", True, id="exact-kernels"),
            pytest.param("exact", False, id="exact-plain"),
            pytest.param(None, True, id="dense-kernels"),
            pytest.param(None, False, id="dense-plain")]


@pytest.mark.parametrize("lazy, use_kernels", VARIANTS)
def test_a_profiled_solve_nests_its_spans(lazy, use_kernels):
    _, got = _profiled(lambda: api.solve(_spec(lazy_updates=lazy, use_kernels=use_kernels)))
    want = {"rt/solve": 1, "rt/outer": K, "rt/epoch": K, "rt/snapshot": K + 1,
            "rt/evaluate": K, "rt/draw": 2 * K, "rt/step": K * M}
    if lazy == "exact":
        want["rt/flush"] = K
    assert _counts(got) == want
    for inner, outer in [("rt/step", "rt/epoch"), ("rt/draw", "rt/epoch"),
                         ("rt/flush", "rt/epoch"), ("rt/epoch", "rt/outer"),
                         ("rt/evaluate", "rt/outer"), ("rt/outer", "rt/solve"),
                         ("rt/snapshot", "rt/solve")]:
        assert _nested(got, inner, outer), (inner, outer)
    # The outer-0 snapshot comes before the first outer; each other one
    # sits in its outer, after the epoch and before the evaluation.
    first, *rest = got["rt/snapshot"]
    assert not _parents(first, got["rt/outer"]) and first[1] <= got["rt/outer"][0][0]
    for snap, epoch, ev in zip(rest, got["rt/epoch"], got["rt/evaluate"], strict=True):
        assert len(_parents(snap, got["rt/outer"])) == 1
        assert epoch[1] <= snap[0] and snap[1] <= ev[0]
    assert all(len(_parents(s, got["rt/step"])) == 1 for s in got["rt/step"])  # none in another


@pytest.mark.parametrize("lazy", ["exact", None])
def test_no_profiler_makes_no_range_and_the_same_bits(monkeypatch, lazy):
    traced, got = _profiled(lambda: api.solve(_spec(lazy_updates=lazy)))
    assert got["rt/step"]
    made = []
    init = record_function.__init__

    def spy(self, *args, **kw):
        made.append(args)
        init(self, *args, **kw)

    def fast(name):
        made.append((name,))
        return range_guard(name)

    range_guard = spans._RecordFunctionFast
    monkeypatch.setattr(record_function, "__init__", spy)
    monkeypatch.setattr(spans, "_RecordFunctionFast", fast)
    plain = api.solve(_spec(lazy_updates=lazy))
    assert made == []
    _same_run(traced, plain)
    _profiled(lambda: api.solve(_spec(lazy_updates=lazy)))
    assert ("rt/step",) in made  # the spy sees the ranges a profiler asks for


def test_span_is_a_range_only_while_a_profiler_records():
    assert not spans.recording()
    off = spans.span("rt/x")
    assert not isinstance(off, spans._RecordFunctionFast) and off is spans.span("rt/y", False)
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        assert isinstance(spans.span("rt/x"), spans._RecordFunctionFast)
        assert spans.span("rt/x", False) is off
        with spans.span("rt/x"):
            torch.zeros(3).add_(1)
    assert not spans.recording()
    assert _counts(_spans(prof)) == {"rt/x": 1}


@pytest.mark.parametrize("method", ["serial", "dsvrg", "fd_saga"])
def test_every_driver_gets_the_outer_spans(method):
    spec = _spec(method, q=1 if method == "serial" else Q)
    res, got = _profiled(lambda: api.solve(spec))
    assert len(res.history) == K
    counts = _counts(got)
    assert {k: counts[k] for k in ("rt/solve", "rt/outer", "rt/epoch", "rt/snapshot",
                                   "rt/evaluate")} == {
        "rt/solve": 1, "rt/outer": K, "rt/epoch": K, "rt/snapshot": K + 1, "rt/evaluate": K}
    assert _nested(got, "rt/epoch", "rt/outer") and _nested(got, "rt/outer", "rt/solve")


# ---------------------------------------------------------------------------
# Two spawned gloo ranks of the sharded driver
# ---------------------------------------------------------------------------


def _rank_sharded_spans(mesh):
    """On each rank: a profiled ``fdsvrg_sharded`` solve's span counts and
    whether each span sits where it should."""
    _, got = _profiled(lambda: api.solve(_spec("fdsvrg_sharded", mesh=mesh)))
    pairs = [("rt/step", "rt/epoch"), ("rt/draw", "rt/epoch"), ("rt/epoch", "rt/outer"),
             ("rt/evaluate", "rt/outer"), ("rt/outer", "rt/solve"), ("rt/block_of", "rt/solve"),
             ("rt/all_gather", "rt/solve"), ("rt/all_reduce", "rt/solve")]
    in_steps = sum(len(_parents(x, got["rt/step"])) for x in got["rt/all_reduce"])
    in_evals = sum(len(_parents(x, got["rt/evaluate"])) for x in got["rt/all_gather"])
    return {"counts": _counts(got), "nested": {f"{a} in {b}": _nested(got, a, b)
                                                for a, b in pairs},
            "all_reduce_in_steps": in_steps, "all_gather_in_evaluate": in_evals}


def test_sharded_ranks_record_their_spans(tmp_path):
    out = spawn_ranks(Q, _rank_sharded_spans, device="cpu", timeout_s=SPAWN_S,
                      workdir=str(tmp_path))
    assert out["counts"] == {
        "rt/solve": 1, "rt/block_of": 1, "rt/outer": K, "rt/epoch": K, "rt/snapshot": K + 1,
        "rt/evaluate": K, "rt/draw": 2 * K, "rt/step": K * M,
        "rt/all_reduce": K * M + K + 1,  # one a step and one a snapshot
        "rt/all_gather": 2 * K + 1,  # w and z an evaluation, w at the end
    }
    assert all(out["nested"].values()), out["nested"]
    assert out["all_reduce_in_steps"] == K * M
    assert out["all_gather_in_evaluate"] == 2 * K
