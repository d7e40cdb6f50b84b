"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and new BENCHMARK.json entries alone: no file of the
benchmark changes, and the harness finds them by name."""

import hashlib
import json
import time

from bench import harness
from bench.tests.conftest import add_tiny_cells, copy_bench

METRIC = '''"""Samples an outer: a metric a later change might add."""


def read(ctx):
    return ctx.samples / max(1, ctx.steps) * 0 + 42.0
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()}


def test_new_files_only(tmp_path):
    root = copy_bench(tmp_path)
    before = _digests(root)
    add_tiny_cells(root)  # a configuration, three traffic mixes, three cells
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench/metrics/answer.train.py").write_text(METRIC)
    bench["per_layer"].append({"name": "answer.train", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "train_samples_per_s", "workloads": ["tiny-lazy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())  # nothing edited
    cell = harness.load_cell("tiny-lazy", root)
    line, _ = harness.execute(cell, seed=9, seconds=0.3, trace=True, t_start=time.time(),
                              device="cpu")
    assert line["metrics"]["answer.train"] == {"value": 42.0, "unit": "1"}
    assert line["correct"] is True
