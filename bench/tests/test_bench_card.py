"""The tiny cells on the card: correct, and a traced run reads every
per-layer metric of its cell from a trace that saw the device work.
Marked ``cuda``; the fixture skips them where there is no card."""

import time

import pytest
import torch

from bench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-lazy", "tiny-dense"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(tiny_root, card, name, trace):
    cell = harness.load_cell(name, tiny_root)
    line, setup = harness.execute(cell, seed=2**31 + 3, seconds=0.5, trace=trace,
                                   t_start=time.time(), device=card)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
        assert 0 < line["metrics"]["mfu.train"]["value"] <= 100
        assert 0 < line["metrics"]["kernels_roofline.train"]["value"] <= 100
        assert setup["lost_records"] == 0
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
