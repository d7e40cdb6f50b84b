"""Command line of the benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs[].file``, a JSON file of sizes
that names its plain reference under ``bench/references/``) and a traffic
mix (``bench/workloads/<traffic>.json``); its limits are in
``bench/limits/<cell>.json`` and each metric is read by
``bench/metrics/<metric>.py``.  A cell, a mix, a configuration or a metric
is added by adding such files and entries, without editing this one.

The last line of standard output is the result: ``correct``, ``attempted``
and ``failed`` (inner steps of the measured call), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number the
comparison held to its limit.  The line before it is the set-up's
breakdown.  Standard error ends with the checked numbers.  Without a CUDA
card, or with fewer cards than the cell asks for, the run prints no
result and exits 1; so it does when a module of JAX or of the JAX package
has been loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Top-level module names a run must never have loaded, compared whole.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"})


class CellError(RuntimeError):
    """The cell or one of its files is missing or malformed."""


@dataclasses.dataclass
class CellDef:
    name: str
    root: pathlib.Path
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _read_json(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise CellError(f"missing file {path}") from None


def load_cell(name: str, root: pathlib.Path = ROOT) -> CellDef:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = _read_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == cell["config"]), None)
    if conf is None:
        raise CellError(f"workload {name!r} names no known config {cell['config']!r}")
    config = _read_json(root / conf["file"])
    traffic = _read_json(root / "bench" / "workloads" / f"{cell['traffic']}.json")
    limits_path = root / "bench" / "limits" / f"{name}.json"
    limits = _read_json(limits_path) if limits_path.exists() else {}

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return CellDef(name=name, root=root, chips=int(cell["chips"]), config=config, traffic=traffic,
                   limits=limits,
                   end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                   per_layer=[m for m in bench["per_layer"] if applies(m)])


def _module(path: pathlib.Path, name: str):
    if not path.exists():
        raise CellError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up while it loads
    spec.loader.exec_module(mod)
    return mod


def read_metrics(metrics: list, ctx, root: pathlib.Path = ROOT) -> dict:
    """Each metric's reader ``bench/metrics/<name>.py``'s ``read(ctx)``; a
    reader that finds nothing to read returns None and the metric is left
    out."""
    out = {}
    for m in metrics:
        reader = _module(root / "bench" / "metrics" / f"{m['name']}.py",
                         "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def reference(config: dict, root: pathlib.Path = ROOT):
    """The configuration's plain reference module."""
    name = config["reference"]
    return _module(root / "bench" / "references" / f"{name}.py", "bench_reference_" + name)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _card() -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}


def judge_run(cell: CellDef, run, device) -> tuple[bool, dict]:
    """Replay the run with the plain reference on ``device`` and hold the
    program's outputs to the cell's limits: (correct, each number beside
    its limit)."""
    from bench import cell as cell_lib
    from bench import compare

    cfg, traffic = cell.config, cell.traffic
    data = cell_lib.make_data(cfg, run.data_seed, device)
    if data.fingerprint() != tuple(run.fingerprint):
        raise CellError("the reference's data differ from the program's for the same seed")
    ref_mod = reference(cfg, cell.root)
    ref = ref_mod.replay(
        data, lam=cfg["lam"], eta=cfg["eta"], batch=traffic["batch_size"],
        inner_steps=cell_lib.inner_steps(cfg, traffic),
        warmup=(run.warmup_seed, cell_lib.WARMUP_OUTERS), window=(run.window_seed, run.compared))
    got = ref_mod.Outputs(objectives=list(run.objectives), grad_norms=list(run.grad_norms),
                          change_norm=run.change_norm)
    return compare.judge(compare.numbers(got, ref), cell.limits)


def execute(cell: CellDef, *, seed: int, seconds: float, trace: bool, t_start: float,
            device: str = "cuda", backend: str = "nccl", prepare=None) -> tuple[dict, dict]:
    """Run the cell: its result line, and its set-up's breakdown."""
    import torch

    from bench import cell as cell_lib
    from bench import trace as trace_lib

    kw = dict(seed=seed, seconds=seconds, trace=trace, t_start=t_start, device=device)
    if cell.traffic.get("ranks", 1) > 1:
        run = cell_lib.run_sharded(cell.config, cell.traffic, ranks=cell.traffic["ranks"],
                                   backend=backend, prepare=prepare, **kw)
    else:
        run = cell_lib.run_one_card(cell.config, cell.traffic, **kw)
    from repro_torch.api import BLOCK_CACHE

    BLOCK_CACHE.clear()  # the program's state goes before the reference runs
    if device == "cuda":
        torch.cuda.empty_cache()
    ref_device = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    ok, checks = judge_run(cell, run, ref_device)
    ctx = run.context
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx, cell.root)
    dev = _card() if device == "cuda" else {"platform": "cpu", "kind": "cpu"}
    dev.update(count=cell.chips, memory_peak_bytes=run.memory_peak_bytes)
    failed = run.failed_outers * cell_lib.inner_steps(cell.config, cell.traffic)
    line = {"correct": ok, "attempted": ctx.steps, "failed": failed, "metrics": metrics,
            "device": dev}
    if trace and ctx.trace is not None:
        dev.update(busy_s=ctx.trace.busy_s(), window_s=ctx.window_s)
        line["breakdown"] = {"device_ops": trace_lib.device_ops(ctx.trace),
                             "idle_gaps": trace_lib.idle_gaps(ctx.trace)}
    line["checks"] = checks
    setup = {"setup_s": ctx.setup_s, **run.setup, "outers": run.outers}
    if trace:
        setup["lost_records"] = ctx.lost_records
    return line, setup


def main(argv=None) -> int:
    t_start = time.time()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device; no result", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found; no result", file=sys.stderr)
        return 1
    line, setup = execute(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          t_start=t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"bench: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"setup": setup}), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def configure_caches() -> None:
    """Build and kernel caches in fixed directories of the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
