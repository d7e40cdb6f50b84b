"""The work counts against hand counts, and the same count for the dense
and the exact-lazy route of one cell."""

import numpy as np
import torch

from bench import cell as cell_lib
from bench import harness, roofline


def test_step_and_snapshot_by_hand():
    # 2 rows of 3 entries with ids {1, 2, 5} and {2, 5, 9}: 6 entries, 4 distinct.
    w = roofline.step_work(entries=6, distinct=4, u=2, width=10)
    assert w.bytes == 6 * 8 + 4 * 12 + 2 * 8
    assert w.flops == 6 * 4 + 10 * 4 + 2 * 10
    s = roofline.snapshot_work(entries=30, n=10)
    assert (s.bytes, s.flops) == (30 * 8 + 10 * 8, 30 * 4 + 10 * 10)
    assert roofline.outer_vector_work(10).bytes == 160


def test_step_counts_by_hand():
    idx = torch.tensor([[1, 2, 5], [2, 5, 9], [0, 0, 3]], dtype=torch.int32)
    val = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 0.0, 1.0]])
    samples = np.array([[0, 1], [2, 2], [1, 1]])
    entries, distinct = roofline.step_counts(idx, val, samples, 0, 10)
    assert entries.tolist() == [6, 4, 6]  # a stored zero is no entry
    assert distinct.tolist() == [4, 2, 3]
    entries, distinct = roofline.step_counts(idx, val, samples, 2, 6)  # a block [2, 6)
    assert entries.tolist() == [4, 2, 4] and distinct.tolist() == [2, 1, 2]


def test_window_is_the_sum_of_its_parts():
    idx = torch.tensor([[1, 2, 5], [2, 5, 9], [0, 4, 3]], dtype=torch.int32)
    val = torch.ones(3, 3)
    draws = [np.array([[0, 1], [2, 2]]), np.array([[1, 0], [0, 0]])]
    got = roofline.window_work(idx, val, draws, 0, 10)
    want = roofline.Work()
    snap = roofline.snapshot_work(9, 3)
    want += snap
    want += roofline.first_snapshot_vector_work(10)
    for samples in draws:
        entries, distinct = roofline.step_counts(idx, val, samples, 0, 10)
        for e, t in zip(entries.tolist(), distinct.tolist()):
            want += roofline.step_work(e, t, 2, 10)
        want += roofline.outer_vector_work(10)
        want += snap
    assert (got.bytes, got.flops) == (want.bytes, want.flops)
    assert got.least_seconds()[0] == max(want.bytes / roofline.PEAK_BYTES_PER_S,
                                         want.flops / roofline.PEAK_F32_FLOP_PER_S)


def test_dense_and_lazy_routes_count_alike(tiny_root, monkeypatch):
    monkeypatch.setattr(cell_lib, "window_outers", lambda t, s: 3)
    least = {}
    for name in ("tiny-dense", "tiny-lazy"):
        cell = harness.load_cell(name, tiny_root)
        run = cell_lib.run_one_card(cell.config, cell.traffic, seed=11, seconds=1.0,
                                    trace=True, t_start=0.0, device="cpu")
        least[name] = run.context.least_s
    assert least["tiny-dense"] == least["tiny-lazy"] > 0
