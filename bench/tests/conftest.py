"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark in
a temporary directory, with tiny cells beside the real ones."""

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO / "src") not in sys.path:  # the port, as bench/run.py finds it
    sys.path.insert(0, str(REPO / "src"))
TINY = {"dim": 997, "num_instances": 256, "nnz_per_instance": 16, "workers": 4}
TINY_BATCH = 8
# The tiny cells are held to the limits of a real cell; the dense route's
# news20 cell was left out (host-paced), so the tiny dense cell takes the
# exact-lazy one's, which computes the same bits.
TINY_CELLS = {"tiny-lazy": ("lazy-u64", "news20-lazy-u128"),
              "tiny-dense": ("dense-u64", "news20-lazy-u128"),
              "tiny-shard": ("sharded-nccl4", "webspam-sharded-nccl4")}


def copy_bench(dest: pathlib.Path) -> pathlib.Path:
    """``BENCHMARK.json`` and ``bench/`` copied under ``dest``."""
    shutil.copytree(REPO / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def add_tiny_cells(root: pathlib.Path) -> None:
    """Add the tiny configuration and its cells (files and entries only)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench/configs/fdsvrg-news20.json").read_text())
    cfg.update(name="tiny", **TINY)
    (root / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": [],
                             "file": "bench/configs/tiny.json", "why": "test"})
    for name, (traffic, like) in TINY_CELLS.items():
        t = json.loads((root / f"bench/workloads/{traffic}.json").read_text())
        t.update(batch_size=TINY_BATCH, trace_seconds=0.3)
        (root / f"bench/workloads/tiny-{traffic}.json").write_text(json.dumps(t))
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": f"tiny-{traffic}",
                                   "chips": 1, "why": "test"})
        shutil.copy(root / f"bench/limits/{like}.json", root / f"bench/limits/{name}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_bench(tmp_path)
    add_tiny_cells(root)
    return root
