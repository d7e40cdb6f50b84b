"""No module a run loads has the top-level name of JAX or of the JAX
package, compared whole: ``repro_torch`` passes, ``repro`` does not."""

import json
import subprocess
import sys
import types

from bench import harness
from bench.tests.conftest import REPO

RUN_TINY = """
import json, pathlib, sys, time
sys.path[:0] = [{repo!r}, {src!r}]
from bench import harness
from bench.tests.conftest import add_tiny_cells, copy_bench
root = copy_bench(pathlib.Path({tmp!r}))
add_tiny_cells(root)
for name in ("tiny-lazy", "tiny-dense"):
    harness.execute(harness.load_cell(name, root), seed=5, seconds=0.2, trace=False,
                    t_start=time.time(), device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike.sub", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_loaded() == ["jaxlib", "repro"]


def test_a_run_loads_none(tmp_path):
    code = RUN_TINY.format(repo=str(REPO), src=str(REPO / "src"), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names and "bench" in names
    assert not names & harness.FORBIDDEN
