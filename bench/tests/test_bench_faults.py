"""The comparison that decides ``correct`` fails what it must.

A sound run of each tiny cell is correct.  A run with the timed path
broken underneath (the chip check skipped, everything else as in a run)
is not: a step that returns its state unchanged, half of each mini-batch
left out with the mean taken over the rest, a reported objective altered
where it is produced, and on the sharded cell the exchange of the margins
between the ranks left out.  The control, the plain reference in
bfloat16 put in the program's place, fails too.
"""

import time

import pytest
import torch

from bench import calibrate, compare, harness


def _frozen(mp):
    from repro_torch.optim import update_rules

    mp.setattr(update_rules, "_inner_epoch", lambda bd, w0, *a, **k: w0.clone())
    mp.setattr(update_rules, "_lazy_inner_epoch", lambda bd, w0, *a, **k: w0.clone())


def _half_batch(mp):
    from repro_torch.optim import update_rules

    draw = update_rules.draw_samples

    def half(rng, n, m, u):
        s = draw(rng, n, m, u)
        s[:, u // 2:] = s[:, : u // 2]  # the first half twice: u is even
        return s

    mp.setattr(update_rules, "draw_samples", half)


def _answer_altered(mp):
    from repro_torch.core import driver

    value = driver.objective_from_margins
    mp.setattr(driver, "objective_from_margins", lambda *a: value(*a) * (1 + 1e-3))


def _rank_no_exchange():
    from repro_torch.dist.shardmap import ShardMapBackend

    ShardMapBackend.device_all_reduce = lambda self, x: x


def _rank_frozen():
    from repro_torch.core import fdsvrg_shardmap

    fdsvrg_shardmap._inner_scan_blk = lambda cfg, be, loss, reg, block, w, *a: w.clone()


def _run(root, name, prepare=None):
    cell = harness.load_cell(name, root)
    line, _ = harness.execute(cell, seed=2**31 + 77, seconds=0.3, trace=False,
                              t_start=time.time(), device="cpu", backend="gloo",
                              prepare=prepare)
    return line


@pytest.mark.parametrize("name", ["tiny-lazy", "tiny-dense"])
@pytest.mark.parametrize("fault", [None, _frozen, _half_batch, _answer_altered])
def test_one_card(tiny_root, monkeypatch, name, fault):
    if fault is not None:
        fault(monkeypatch)
    line = _run(tiny_root, name)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("prepare", [None, _rank_frozen, _rank_no_exchange])
def test_sharded(tiny_root, prepare):
    line = _run(tiny_root, "tiny-shard", prepare)
    assert line["correct"] is (prepare is None), line["checks"]


@pytest.mark.parametrize("name", ["tiny-lazy", "tiny-shard"])
def test_control_fails(tiny_root, name):
    cell = harness.load_cell(name, tiny_root)
    readings = calibrate.stand_ins(cell, 2**31 + 5, torch.device("cpu"))
    for kind in ("control", "half_batch") + (("no_exchange",) if "shard" in name else ()):
        got = next(r for r in readings if r["kind"] == kind)
        ok, checks = compare.judge({k: got[k] for k in compare.NAMES}, cell.limits)
        assert not ok, (kind, checks)
