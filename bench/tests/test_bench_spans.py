"""The readers of the program's spans (``bench/spans.py`` and the four
``bench/metrics/*.train.py`` built on it) on hand-made traces: the idle
gaps split between the steps and the rest, the two shares summing to
``device_idle_share.train``, the host's own time a step, the snapshot's
kernels found through their launches, and nothing read from a program
without spans.  A traced CPU run shows the spans arrive in the trace; the
``cuda`` cases run on the card (the fixture skips them elsewhere)."""

import math
import time

import pytest
import torch

from bench import cell as cell_lib
from bench import harness
from bench import spans as span_lib
from bench import trace as trace_lib
from bench.cell import Context
from bench.tests.conftest import REPO
from bench.trace import Trace

NEW = ("snapshot_span_share.train", "step_idle_share.train", "outer_idle_share.train",
       "step_host_us.train")


def _read(ctx, names=NEW) -> dict:
    metrics = [{"name": n, "unit": "x"} for n in names]
    return {k: v["value"] for k, v in harness.read_metrics(metrics, ctx, REPO).items()}


def _ctx(kernels, host, wall=10.0, steps=2) -> Context:
    return Context(setup_s=0.0, window_s=wall, steps=steps, samples=steps,
                   trace=Trace(kernels=sorted(kernels, key=lambda k: k[1]),
                               host=sorted(host, key=lambda h: h[1]), wall_s=wall))


# Kernels busy [0, 1], [2, 3], [5, 6], [8, 9] of a 10 s window: idle 6 s, the
# gaps (1, 2), (3, 5), (6, 8) between kernels 4 s of it.  Two steps cover
# (0.5, 1.5) and (2.5, 4): 0.5 + 1 s of the gaps.
KERNELS = [("margins_kernel", 0.0, 1.0), ("entries_kernel", 2.0, 3.0),
           ("margins_kernel", 5.0, 6.0), ("snapshot_coef_kernel", 8.0, 9.0)]
STEPS = [("rt/step", 0.5, 1.5), ("rt/step", 2.5, 4.0)]
LAUNCHES = [("cudaLaunchKernel", 0.1, 0.2), ("cudaLaunchKernel", 1.0, 1.1),
            ("cudaLaunchKernel", 4.5, 4.6), ("cudaLaunchKernel", 7.0, 7.1)]
SNAP = [("rt/snapshot", 4.2, 7.5)]


def test_idle_split_between_steps_and_the_rest():
    ctx = _ctx(KERNELS, STEPS + LAUNCHES + SNAP)
    got = _read(ctx)
    assert ctx.idle_share() == pytest.approx(0.6)
    assert got["step_idle_share.train"] == pytest.approx(0.15)
    assert got["outer_idle_share.train"] == pytest.approx(0.45)
    assert got["step_idle_share.train"] + got["outer_idle_share.train"] == \
        pytest.approx(ctx.idle_share(), abs=1e-15)


def test_overlap_merges_and_clips():
    assert span_lib.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert span_lib.overlap([(0, 10)], [(1, 2), (1.5, 3), (9, 12)]) == pytest.approx(3.0)
    assert span_lib.overlap([], [(0, 1)]) == 0.0


def test_snapshot_kernels_found_by_their_launches():
    got = _read(_ctx(KERNELS, STEPS + LAUNCHES + SNAP))
    # The launches at 4.5 and 7.0 lie in the snapshot: kernels 3 and 4, 2 s of 4.
    assert got["snapshot_span_share.train"] == pytest.approx(0.5)
    # A driver call inside a runtime call is the same launch.
    nested = LAUNCHES + [("cuLaunchKernel", 4.52, 4.58)]
    assert _read(_ctx(KERNELS, STEPS + nested + SNAP))["snapshot_span_share.train"] == \
        pytest.approx(0.5)


@pytest.mark.parametrize("launches", [LAUNCHES[:3], LAUNCHES + [("cudaLaunchKernel", 9.5, 9.6)]])
def test_snapshot_share_none_when_launches_and_records_differ(launches):
    assert "snapshot_span_share.train" not in _read(_ctx(KERNELS, STEPS + launches + SNAP))


def test_host_time_a_step_leaves_out_the_waits():
    waits = [("Command Buffer Full", 0.6, 0.8), ("cudaStreamSynchronize", 3.0, 3.5),
             ("cudaLaunchKernel", 3.1, 3.2),  # inside the sync: no second wait
             ("Command_Buffer_Full", 3.4, 4.4)]  # past the step's end: 0.5 s of it in
    got = _read(_ctx(KERNELS, STEPS + waits))
    # Steps of 1 s and 1.5 s, less 0.2 s and 1.0 s of waiting.
    assert got["step_host_us.train"] == pytest.approx(1e6 * (2.5 - 1.2) / 2)
    assert span_lib.is_wait("cudaDeviceSynchronize") and span_lib.is_wait("Command_Buffer_Full")
    assert not span_lib.is_wait("cudaMemcpyAsync") and not span_lib.is_wait("rt/step")


def test_nothing_read_without_spans_or_kernels():
    assert _read(_ctx(KERNELS, LAUNCHES)) == {}  # a program that records no span
    assert _read(_ctx([], STEPS + LAUNCHES + SNAP)) == {}  # no device records
    assert _read(Context(setup_s=0.0, window_s=1.0, steps=1, samples=1)) == {}


def test_a_traced_cpu_run_carries_the_programs_spans(tiny_root):
    cell = harness.load_cell("tiny-lazy", tiny_root)
    run = cell_lib.run_one_card(cell.config, cell.traffic, seed=2**31 + 11, seconds=0.3,
                                trace=True, t_start=time.time(), device="cpu")
    ctx = run.context
    assert len(span_lib.named(ctx.trace, "rt/step")) == ctx.steps
    assert len(span_lib.named(ctx.trace, "rt/outer")) == run.outers
    assert len(span_lib.named(ctx.trace, "rt/snapshot")) == run.outers + 1
    assert len(span_lib.named(ctx.trace, "rt/solve")) == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_spans_add_no_kernel_records(tiny_root, card):
    """With spans on, every kernel record is one of the program's launches
    (the device-side ranges of the spans are no kernels), and the records
    of each counted kernel equal its launch counter."""
    from repro_torch.api import solve
    from repro_torch.kernels import _build, ops

    _build.load_library()
    cell = harness.load_cell("tiny-lazy", tiny_root)
    cfg, traffic = cell.config, cell.traffic
    device = torch.device("cuda", 0)
    sset = cell_lib.make_data(cfg, 7, device)
    from repro_torch.data.sparse import PaddedCSR

    data = PaddedCSR(indices=sset.indices, values=sset.values, labels=sset.labels, dim=sset.dim)
    spec = cell_lib._spec(cfg, traffic, data, outers=3, seed=5, init_w=None, device=device)
    solve(spec)  # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _, tr = trace_lib.traced(lambda: solve(spec), torch.cuda.synchronize)
    launches = ops.launch_counts()
    assert not any(name.startswith("rt/") for name, _, _ in tr.kernels)
    assert trace_lib.lost_records(tr.kernels, launches) == 0
    kept: dict[str, int] = {}
    for name, _, _ in tr.kernels:
        c = trace_lib.counter_of(name)
        if c is not None:
            kept[c] = kept.get(c, 0) + 1
    assert kept == {c: n for c, n in launches.items() if n}
    assert len(span_lib.launches(tr)) == len(tr.kernels)
    assert len(span_lib.named(tr, "rt/step")) == 3 * cell_lib.inner_steps(cfg, traffic)


@pytest.mark.cuda
def test_news20_cell_reads_the_span_metrics(card):
    cell = harness.load_cell("news20-lazy-u128")
    line, setup = harness.execute(cell, seed=2**31 + 17, seconds=1.0, trace=True,
                                  t_start=time.time(), device=card)
    assert line["correct"] is True, line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(m)
    assert math.isclose(m["snapshot_span_share.train"], m["snapshot_share.train"], rel_tol=0.1)
    assert m["step_idle_share.train"] + m["outer_idle_share.train"] == \
        pytest.approx(m["device_idle_share.train"], abs=1e-12)
    assert m["step_host_us.train"] > 0 and setup["lost_records"] == 0
