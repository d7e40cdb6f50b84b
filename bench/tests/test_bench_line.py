"""The result line has exactly the contract's keys, ``checks`` last, and a
run without a card prints no result."""

import json
import time

import pytest

from bench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(tiny_root, trace):
    cell = harness.load_cell("tiny-lazy", tiny_root)
    line, setup = harness.execute(cell, seed=3, seconds=0.3, trace=trace,
                                   t_start=time.time(), device="cpu")
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    json.dumps(line)  # one JSON object
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["correct"] is True
    assert "setup_s" in setup and "warmup_s" in setup


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = harness.main(["--workload", "news20-lazy-u128", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    rc = harness.main(["--workload", "news20-lazy-u128", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
